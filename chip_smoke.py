#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/pd_fusion_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py --compare-with <path of another attention_pool.cu>

Phases; any failure exits non-zero before the final line:
1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build kernel K1 (``csrc/attention_pool.cu``) from the repo's sources
   with nvcc, and the host IO library with g++, in parallel (set-up time
   and the ``-Xptxas=-v`` report, printed; the
   report must show no spills); ``--compare-with`` builds that source too,
   in parallel, with the same flags and the C interface K1 had first
   (scores, mask, h, pooled, weights, B, L, H, stream);
3. K1 against its plain PyTorch version on the card, forward and
   gradient (``pd_fusion_torch/ops/attention_pool_checks.py``, the checks
   the ``cuda``-marked tests run too), at every shape there: the MIL
   configs' (L=48 at B=16 and 80, L=64, L=72), a staged long bag, tails
   of H on both the float4 and the scalar path, a bag of one, all-masked
   bags and an unaligned h; then, at the MIL configs' shapes, K1 and the
   plain version timed with CUDA events beside the bound and the launch
   floor (a one-element ``zero_()``): device time from CUDA-graph
   replays, and time per call with the host work (median of 200 calls
   after warm-up); K1 and the plain version again on a long bag, which K1
   stages through two buffers; with ``--compare-with``,
   that kernel and K1 timed in turns (other, K1, K1, other) at each
   shape; the full-width MIL head (``mil_apply``, D=2048) on the card
   against the same head on the CPU; and a ``torch.profiler`` window over
   two epochs of the MIL trainer at full width: the device's busy share,
   its top kernels, and K1's backward (torch ops) as a ``record_function``
   range: its device time and kernel launches;
4. the ds001907 MIL-attention CV slice at full width through the port's
   CLI (``python -m pd_fusion_torch.cli run --config <abs path>``) on
   seeded synthetic bags (48 subjects x 2 sessions, 48 slices x 2048):
   5-fold group CV, nested isotonic calibration, 7 missingness scenarios,
   the repo's model/CV/calibration settings. Launch counters are zeroed
   just before the run and read just after: the kernel must have run and
   the plain version must not have. The fold-1 plots' CSV twins must
   exist, and their PNGs where matplotlib is installed. Then the slice
   runs once more under ``torch.profiler``: K1's summed device time and
   its wrapper's host time against the device's busy time and the wall;
5. the tabular slice (no kernel of its own: torch ops, as the JAX
   package's XLA programs): the fold-batched trainer
   (``nn/trainer.py::minibatch_moddrop_impl``) at the bench CV frame's
   widths (K=5, n=400, 35 features, [64, 32], batch 32, 50 epochs, moddrop
   0.3, dropout 0.2) on the card and on the CPU with the same explicit
   draws, and a short ``per_sample`` run, held to
   ``nn/trainer_checks.py``'s tolerances, and the MLP forward likewise;
6. the single-split quickstart through the CLI (``run --config <abs
   path>/configs/quickstart.yaml --synthetic``): its artifacts, then
   ``evaluate --run-dir`` must give ``results.yaml``'s deterministic
   scenarios to 1e-6; seed 42's full-observation ROC-AUC is printed beside
   the reference band, and the mean ROC-AUC over 64 generator chains on the
   card must lie within 3 standard errors of the JAX package's (one seed's
   AUC is mostly its initial weights': see ``QUICKSTART_BAND``);
7. the bench CV frame through the CLI (``--k-fold 5 --model
   fusion_moddrop``: N=500, the frame of ``bench.py:97-116``): artifacts,
   6 scenarios, a mean full-observation ROC-AUC > 0.75, K1 launched
   neither as kernel nor plain, the trainer's wall and steps; its trainer
   call again for 2 epochs under ``torch.profiler`` (device and host time
   and kernel launches a step, top device ops); the whole CV once more
   under the profiler for the device's busy share;
8. the scaled CV frame (N=5000, K=10, ``bench.py:608-626``) likewise, its
   busy share from the trainer window (the whole run's profile takes
   minutes to read back);
9. device isotonic (``ops/isotonic.py``) against the host fit on the
   shared sets (``pd_fusion_torch/ops/isotonic_checks.py``: identical tie
   classes, equal or within one ulp of [0, 1]), then profiled at K=5,
   Nc=100 and K=10, Nc=4096 with its peak memory;
10. the bench CV frame with ``calibrate: true``, val-calibrated and
   nested, each once on the device isotonic arm and once under
   ``PD_FUSION_HOST_ISOTONIC=1``: per-fold metrics within 2e-3, and the
   engine's arm counters show which arm ran;
11. the MoE: the fold-batched trainer card vs CPU from one init after 50
   epochs; ``--k-fold 5 --model moe``, calibrated and not (wall, AUC, the
   trainer's steps, launches and device time a step, the run's busy
   share); the single-split quickstart with ``--model moe`` and its
   ``evaluate --run-dir``;
12. the device GBDT (``--model unimodal_clinical`` resolves to it on the
   card): two fits bit-identical under ``hist_mode: auto`` (onehot); the
   fold-batched fit bit-identical to per-fold fits; card vs CPU, trees
   equal or both passing the split-optimality audit
   (``nn/gbdt_checks.py``); a round of each lowering profiled, level
   histograms apart; the 5-fold CV calibrated and not; ``predict_margin``;
   the quickstart and its ``evaluate``; TreeSHAP card vs CPU with
   additivity, and a chunk profiled. K1 must launch 0 times in 10-12;
13. the host IO library (``csrc/pd_io.cpp``, built with g++ in phase 2
   beside K1): its build time and the inflate library linked; the host's
   cores and whether pyarrow is installed;
14. seeded synthetic T1w-like volumes (``imaging/embed_checks.py``): 48
   subjects x 2 sessions, 176x256x256 int16 with a ``scl_slope``, session
   1 ``.nii.gz`` (gzip level 1) and session 2 ``.nii``; PD subjects carry
   a darker deep nucleus;
15. ResNet-50 at full width (224^2, BN folded) on the card against the CPU
   on the slices of two volumes: float32 with TF32 off within
   ``embed_checks.F32_REL`` of the scale, bfloat16 by cosine;
16. the MIL bag builder (``python -m
   pd_fusion_torch.scripts.build_resnet2d_mil_embeddings`` on
   ``configs/data_openneuro_ds001907_resnet2d_mil.yaml``'s settings:
   ResNet-50, 160^3, axis 2, 48 slices, 224^2) over the 96 volumes: wall,
   volumes/s, images/s, ``LAST_PROFILE``, peak device memory; again under
   ``torch.profiler`` (device time, busy share, TFLOP/s); flush widths
   4, 8, 16, 32 in turns (the device program, then the whole pipeline);
   float32, bfloat16 and TF32 in turns (TF32 as a measurement only); the
   flush's device programs profiled;
17. the MIL CV on those bags through the CLI (a copy of
   ``configs/openneuro_ds001907_resnet2d_mil.yaml`` pointed at them): 7
   scenarios, K1 launched, the plain pool never; the AUC printed;
18. the mean-pooled builder (ResNet-18, 24 slices) and the CLI's CV on
   ``configs/openneuro_ds001907_resnet2d.yaml`` (calibrated, nested
   ``fusion_moddrop``; the clinical and DaT groups are empty);
19. the 3-axis TTA bags (``..._mil_multi.yaml``: 3 x 24 slices, ``tta:
   2``) on 16 volumes, volume 0 against the CPU pipeline;
20. a JSON line with each device program's host and device time and
   launches a step; one with each path's wall time, busy share and AUC;
   one with each kernel's launches (by path), error and times (B=16 and
   B=80, and the launch floor); the card line again; then ``{"ok": true,
   "device": {...}}`` as the last line.

Needs a CUDA device and the repo around it; it imports nothing of JAX.
"""
import argparse
import contextlib
import ctypes
import importlib.util
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
MIL_CONFIG = ROOT / "configs" / "openneuro_ds001907_resnet2d_mil.yaml"
QUICKSTART = ROOT / "configs" / "quickstart.yaml"
EVAL_CONFIG = ROOT / "configs" / "eval_missingness.yaml"
# the reference's committed quickstart run: full-observation ROC-AUC 0.7121,
# band 0.12 (tests/test_parity_reference.py:37, 75). The quickstart trains 5
# full-batch steps, so one seed's AUC is mostly its initial weights': over
# 400 JAX key chains it is 0.5957 +- 0.0757 (sd), and the band holds for 53%
# of them (`python tests/test_torch_port_tabular_slice.py 400`, CPU). The
# check is on the mean over QUICKSTART_DRAWS chains on the card.
QUICKSTART_BAND = (0.7121, 0.12)
JAX_QUICKSTART_AUC = (0.5957, 0.0757, 400)  # mean, sd, draws
QUICKSTART_DRAWS = 64
# the bench CV frame: the JAX package's run gives 0.8688 (BENCH_r05.json), chance 0.5
CV_AUC_MIN = 0.75
DETERMINISTIC_SCENARIOS = ("full_observation", "no_dat", "no_mri", "clinical_only")
N_SUBJECTS, N_SLICES, EMB_DIM = 48, 48, 2048
# (B, L, H) of the repo's MIL configs: the CV slice's training step and
# evaluation width (openneuro_ds001907_resnet2d_mil.yaml), the fine-tune
# (..._mil_ft.yaml: batch 4, 64 slices), the 3-axis bags (..._mil_multi:
# 3 x 24 slices, batch 16)
TIMED_SHAPES = [(16, 48, 256), (80, 48, 256), (4, 64, 256), (16, 72, 256)]
LONG_BAG = (2, 4096, 256)  # no MIL config has such bags; K1 stages them through two buffers


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _median_event_ms(torch, run, reps) -> float:
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        run()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def time_call_ms(torch, fn, warmup=20, reps=200) -> float:
    """One call as the main path makes it, host work included: median over
    ``reps`` calls, each between its own pair of CUDA events (at these
    sizes the device waits on the host, so this is mostly launch cost)."""
    for _ in range(warmup):
        fn()
    return _median_event_ms(torch, fn, reps)


def time_device_ms(torch, fn, per_graph=20, reps=100) -> float:
    """Device time of one call: ``per_graph`` calls captured in one CUDA
    graph, the graph replayed ``reps`` times (each replay between its own
    pair of CUDA events), median replay / ``per_graph``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    for _ in range(5):
        graph.replay()
    return _median_event_ms(torch, graph.replay, reps) / per_graph


def time_in_turns(torch, fns) -> dict:
    """Device time (``time_device_ms``) of each of ``fns`` (name -> call),
    timed in turns, in order and then in reverse (a, b, b, a), so that a
    drift of the card's clock falls on both. -> name -> [ms, ms]."""
    times = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            times[name].append(time_device_ms(torch, fns[name]))
    return times


def warm_clocks(torch, seconds=0.2):
    """Keep the card busy for about ``seconds`` so that its clocks are up
    before a timing (after host-side work the card idles, and the first
    timing would run on a lowered clock)."""
    a = torch.randn(2048, 2048, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()


def launch_floor_ms(torch) -> float:
    """Device time of the least launch: a one-element ``zero_()``, timed as
    K1 is (``time_device_ms``)."""
    x = torch.zeros(1, device="cuda")
    return time_device_ms(torch, x.zero_)


def bind_first_interface(torch, lib_path: Path):
    """``attention_pool_forward`` of a library with the C interface K1 had
    first (scores, mask, h, pooled, weights, B, L, H, stream) ->
    ``run(scores, mask, h, pooled, weights)``."""
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.attention_pool_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(scores, mask, h, pooled, weights):
        B, L = scores.shape
        err = fn(scores.data_ptr(), mask.data_ptr(), h.data_ptr(), pooled.data_ptr(),
                 weights.data_ptr(), B, L, h.shape[2], torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{lib_path.name}: launch failed, CUDA error {err}")

    run.lib = lib  # keeps the library loaded
    return run


def check_spills(log: str):
    """The ``-Xptxas=-v`` report must show 0 bytes of spill stores and loads."""
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    if not spills or any(int(a) or int(b) for a, b in spills):
        raise RuntimeError(f"the kernels spill or the report has no spill line: {spills}")


def pool_bound(B, L, H):
    """Least time on an H100 SXM for one forward: bytes moved (inputs read
    once, outputs written once) over HBM rate vs flops over f32 rate."""
    n_bytes = 4 * (B * L * H + 3 * B * L + B * H)
    flops = 2 * B * L * H + 6 * B * L
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return n_bytes, (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_mil_head(torch, np):
    """The full-width MIL head on the card against the same head on the CPU."""
    from pd_fusion_torch.nn.mil import mil_apply, mil_init

    params = mil_init(torch.Generator().manual_seed(0), EMB_DIM, 256, 128, True)
    rng = np.random.RandomState(0)
    x = rng.randn(16, N_SLICES, EMB_DIM).astype(np.float32)
    m = (rng.rand(16, N_SLICES) > 0.2).astype(np.float32)
    m[3] = 0.0
    cpu = mil_apply(params, torch.from_numpy(x), torch.from_numpy(m), gated=True)
    cuda_params = {k: {kk: v.cuda() for kk, v in layer.items()} for k, layer in params.items()}
    card = mil_apply(cuda_params, torch.from_numpy(x).cuda(), torch.from_numpy(m).cuda(), gated=True)
    torch.testing.assert_close(card.cpu(), cpu, atol=1e-4, rtol=1e-4)
    return float((card.cpu() - cpu).abs().max())


K1_BWD_RANGE = "K1 backward (AttentionPool.backward)"


def range_device(torch, prof, name):
    """A ``record_function`` range over all its calls: (calls, device ms,
    kernel launches) of the kernels its ops and their children launched.
    The range's own device-side twin of the same name is left out."""
    def walk(e):
        own = [k for k in e.kernels if k.name != name]
        us, n = sum(k.duration for k in own), len(own)
        for child in e.cpu_children:
            cu, cn = walk(child)
            us, n = us + cu, n + cn
        return us, n

    calls = [e for e in prof.events()
             if e.name == name and e.device_type == torch.autograd.DeviceType.CPU]
    walked = [walk(e) for e in calls]
    return len(calls), sum(w[0] for w in walked) / 1e3, sum(w[1] for w in walked)


def profile_trainer(torch, ap, n=80, epochs=2, top=6):
    """Where the MIL trainer's time goes at full width: ``epochs`` epochs of
    ``train_mil_impl`` on ``n`` bags (batch 16, the slice's settings) under
    ``torch.profiler``, after one warm-up epoch, with K1's backward (torch
    ops) inside a ``record_function`` range. -> (wall ms, summed device ms,
    top ops by device time, (backward calls, device ms, kernel launches)).
    One stream, so device time / wall is the device's busy share."""
    from pd_fusion_torch.nn.mil import mil_init, train_mil_impl

    g = torch.Generator(device="cuda").manual_seed(1)
    X = torch.randn(n, N_SLICES, EMB_DIM, generator=g, device="cuda")
    M = torch.ones(n, N_SLICES, device="cuda")
    y = (torch.arange(n, device="cuda") % 2).float()
    ones = torch.ones(n, device="cuda")
    p0 = mil_init(torch.Generator().manual_seed(0), EMB_DIM, 256, 128, True, device="cuda")

    def run(e):
        return train_mil_impl(p0, X, M, y, ones, X, M, y, ones, g, 5e-4, 1.0, 1.0, e, 16, True,
                              0.2, 1e-3, True, True, patience=8)

    backward = ap.AttentionPool.backward

    def ranged_backward(ctx, *grads):
        with torch.profiler.record_function(K1_BWD_RANGE):
            return backward(ctx, *grads)

    run(1)
    torch.cuda.synchronize()
    ap.AttentionPool.backward = staticmethod(ranged_backward)
    try:
        wall_ms, prof = profiled(torch, lambda: run(epochs))
    finally:
        ap.AttentionPool.backward = staticmethod(backward)
    on_device = device_rows(torch, prof.key_averages())
    on_device.sort(key=_dev_ms, reverse=True)
    return (wall_ms, sum(_dev_ms(e) for e in on_device),
            [(e.key[:70], _dev_ms(e), e.count) for e in on_device[:top]],
            range_device(torch, prof, K1_BWD_RANGE))


def profiled(torch, fn):
    """``fn()`` under ``torch.profiler`` (host and device) -> (wall ms, profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, prof


def device_rows(torch, rows):
    """The device's own rows (kernels, copies). CPU-side op rows carry the
    same time again as their children's, and a record_function range (e.g.
    the optimizer step) has a device-side twin of the same name that spans
    its kernels: both are left out."""
    on_cpu = {e.key for e in rows if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in rows
            if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in on_cpu]


def _dev_ms(e) -> float:
    return e.self_device_time_total / 1e3


K1_SYMBOL = "attention_pool_fwd_kernel"
K1_HOST_RANGE = "K1 wrapper (attention_pool_forward)"


def profile_slice(torch, ap, cli, config_path: Path, out_dir: Path):
    """K1's part of the slice, measured: the slice again, under
    ``torch.profiler``, with K1's forward wrapper inside a
    ``record_function`` range. -> (wall ms, device busy ms, K1 device ms,
    K1 kernels seen, K1 wrapper host ms). The profiler slows the host, so
    the wall and host times here are for reading shares, not for the
    slice's wall time."""
    forward = ap.attention_pool_forward

    def ranged(*args):
        with torch.profiler.record_function(K1_HOST_RANGE):
            return forward(*args)

    ap.attention_pool_forward = ranged
    try:
        wall_ms, prof = profiled(torch, lambda: cli.main(
            ["run", "--config", str(config_path), "--output-dir", str(out_dir)]))
    finally:
        ap.attention_pool_forward = forward
    rows = prof.key_averages()
    on_device = device_rows(torch, rows)
    k1 = [e for e in on_device if K1_SYMBOL in e.key]
    host = [e for e in rows if e.key == K1_HOST_RANGE
            and e.device_type == torch.autograd.DeviceType.CPU]
    if not k1 or not host:
        raise RuntimeError("the profiled slice shows no K1 kernel or no K1 wrapper range")
    return (wall_ms, sum(_dev_ms(e) for e in on_device), sum(_dev_ms(e) for e in k1),
            sum(e.count for e in k1), sum(e.cpu_time_total for e in host) / 1e3)


def write_slice_inputs(np, yaml, tmp: Path):
    """Seeded synthetic bags in the loader's .npz layout and content-
    addressed name, plus copies of the repo's MIL configs that change only
    data_config, manifest_path and resnet2d_cache_dir."""
    from pd_fusion_torch.data.openneuro_features import _cache_stem

    cfg = yaml.safe_load(MIL_CONFIG.read_text())
    data_cfg = yaml.safe_load((ROOT / cfg["data_config"]).read_text())
    manifest = tmp / "manifest.csv"
    cache_dir = tmp / "embeddings_resnet2d"
    cache_dir.mkdir()
    data_cfg["manifest_path"] = str(manifest)
    data_cfg["resnet2d_cache_dir"] = str(cache_dir)
    cfg["data_config"] = str(tmp / "data.yaml")
    (tmp / "data.yaml").write_text(yaml.safe_dump(data_cfg))
    config_path = tmp / "mil.yaml"
    config_path.write_text(yaml.safe_dump(cfg))

    rng = np.random.RandomState(0)
    y_subj = rng.permutation(np.repeat([0, 1], N_SUBJECTS // 2))
    sub, ses, lab, bags = [], [], [], []
    for s in range(N_SUBJECTS):
        for session in (1, 2):
            bag = rng.randn(N_SLICES, EMB_DIM).astype(np.float32)
            if y_subj[s]:
                k = rng.randint(1, 4)
                bag[rng.choice(N_SLICES, k, replace=False)] += 1.0
            sub.append(f"sub-{s:03d}")
            ses.append(session)
            lab.append(int(y_subj[s]))
            bags.append(bag)
    lines = ["subject_id,session,label,t1wbrain_path"] + [
        f"{a},{b},{c},/nonexistent/{a}_ses-{b}_T1w.nii.gz" for a, b, c in zip(sub, ses, lab)
    ]
    manifest.write_text("\n".join(lines) + "\n")
    stem = _cache_stem("resnet2d_mil", manifest, data_cfg["resnet2d_config"])
    np.savez(cache_dir / f"{stem}.npz", embeddings=np.stack(bags),
             subject_id=np.array(sub), session=np.array(ses), label=np.array(lab))
    return config_path, int(cfg["cv_folds"])


def run_slice(np, yaml, ap, cli, tmp: Path):
    config_path, k = write_slice_inputs(np, yaml, tmp)
    out_dir = tmp / "run"
    ap.reset_launch_counts()
    t0 = time.perf_counter()
    agg = cli.main(["run", "--config", str(config_path), "--output-dir", str(out_dir)])
    wall = time.perf_counter() - t0
    launches = dict(ap.launch_counts)

    expected = ["results_aggregated.yaml", "fold_assignments.csv", "summary_table.csv"]
    expected += [f"results_fold_{i}.yaml" for i in range(1, k + 1)]
    expected += [f"preds_fold_{i}_full_observation.csv" for i in range(1, k + 1)]
    require_files(out_dir, expected + plot_files(PLOTS, "_fold1"), "slice run")
    on_disk = yaml.safe_load((out_dir / "results_aggregated.yaml").read_text())
    if len(on_disk) != 7 or set(on_disk) != set(agg):
        raise RuntimeError("results_aggregated.yaml does not hold the 7 scenarios returned")
    auc = on_disk["full_observation"]["roc_auc"]["mean"]
    if not (math.isfinite(auc) and auc > 0.7):
        raise RuntimeError(f"full-observation ROC-AUC {auc} is not finite and > 0.7")
    if launches["kernel"] <= 0:
        raise RuntimeError("the slice never launched the attention-pool kernel")
    if launches["plain"] != 0:
        raise RuntimeError(f"the slice called the plain pool {launches['plain']} times")
    return {"wall_s": wall, "launches": launches["kernel"], "auc": auc, "k": k,
            "aggregated": on_disk, "config_path": config_path}


def plot_files(stems, suffix=""):
    """The plots' CSV twins always, their PNGs where matplotlib is installed."""
    exts = ("csv", "png") if importlib.util.find_spec("matplotlib") else ("csv",)
    return [f"{p}{suffix}.{ext}" for p in stems for ext in exts]


PLOTS = ("degradation", "roc_curve", "pr_curve", "calibration", "risk_coverage")


def require_files(out_dir: Path, names, what):
    missing = [f for f in names if not (out_dir / f).exists()]
    if missing:
        raise RuntimeError(f"{what} lacks artifacts: {missing}")


def busy(torch, rows, wall_ms):
    """(device busy ms, busy share of the wall) from a profiled run's
    ``key_averages()``."""
    busy_ms = sum(_dev_ms(e) for e in device_rows(torch, rows))
    return busy_ms, busy_ms / wall_ms


def check_tabular_trainer(torch):
    """The fold-batched trainer and the MLP forward, card against CPU, with
    the same explicit draws (``nn/trainer_checks.py``)."""
    from pd_fusion_torch.nn import trainer_checks as tc

    head_err = tc.check_mlp_apply()
    print(f"tabular mlp_apply (K=5 stacked and single, n=400, [64, 32], dropout keeps) card vs "
          f"CPU: max abs err {head_err:.3e} (atol 1e-5)")
    for epochs, per_sample, atol in ((50, False, tc.FULL_ATOL), (2, True, tc.SHORT_ATOL)):
        inputs = tc.trainer_inputs(epochs=epochs, per_sample=per_sample)
        err_p, err_y, t_card, t_cpu = tc.compare_card_with_cpu(inputs, atol)
        steps = epochs * -(-400 // 32)
        print(f"tabular trainer card vs CPU (K=5 n=400 F=35 [64, 32] batch 32, {epochs} epochs = "
              f"{steps} steps, per_sample={per_sample}, same draws): params max abs err "
              f"{err_p:.3e} (atol {atol[0]}), probs {err_y:.3e} (atol {atol[1]}); wall card "
              f"{t_card:.3f} s ({t_card / steps * 1e6:.1f} us a step), CPU {t_cpu:.3f} s")


def run_quickstart(torch, yaml, cli, tmp: Path):
    """The single-split quickstart through the CLI, its artifacts, and
    ``evaluate --run-dir`` against its results; then once more under the
    profiler for the busy share."""
    out = tmp / "quickstart"
    args = ["run", "--config", str(QUICKSTART), "--synthetic", "--output-dir", str(out)]
    t0 = time.perf_counter()
    cli.main(args)
    wall = time.perf_counter() - t0
    require_files(out, ["model.pt", "preprocess.pkl", "results.yaml"] + plot_files(PLOTS),
                  "the quickstart run")
    results = yaml.safe_load((out / "results.yaml").read_text())
    if len(results) != 6:
        raise RuntimeError(f"results.yaml holds {len(results)} scenarios, not 6")
    cli.main(["evaluate", "--config", str(EVAL_CONFIG), "--run-dir", str(out)])
    again = yaml.safe_load((out / "results_eval.yaml").read_text())
    err = max(abs(again[s][m] - v) for s in DETERMINISTIC_SCENARIOS
              for m, v in results[s].items())
    if not err <= 1e-6:
        raise RuntimeError(f"evaluate --run-dir differs from the run by {err}")
    p_wall, prof = profiled(torch, lambda: cli.main(args[:-1] + [str(tmp / "quickstart_prof")]))
    _, share = busy(torch, prof.key_averages(), p_wall)
    return {"wall_s": wall, "auc": results["full_observation"]["roc_auc"], "busy_share": share,
            "results": results, "eval_err": err}


def check_quickstart_spread():
    """The quickstart's full-observation ROC-AUC over QUICKSTART_DRAWS
    generator chains on the card: the mean must lie within 3 standard
    errors of the JAX package's. -> (mean, sd, half-width of the limit)."""
    from pd_fusion_torch.nn.trainer_checks import quickstart_auc_draws

    aucs = quickstart_auc_draws(QUICKSTART_DRAWS)
    j_mean, j_sd, j_n = JAX_QUICKSTART_AUC
    limit = 3 * math.sqrt(aucs.var(ddof=1) / len(aucs) + j_sd ** 2 / j_n)
    if not abs(aucs.mean() - j_mean) < limit:
        raise RuntimeError(f"quickstart mean ROC-AUC over {len(aucs)} chains {aucs.mean():.4f} is "
                           f"not within {limit:.4f} of the JAX package's {j_mean}")
    return float(aucs.mean()), float(aucs.std(ddof=1)), limit


def run_tabular_cv(torch, yaml, ap, cli, config: Path, k: int, out: Path):
    """One fusion_moddrop CV through the CLI; K1 must not run at all. The
    trainer call is timed (synchronised at both ends) and its arguments
    kept for ``trainer_window``."""
    from pd_fusion_torch.nn import trainer as tt

    args = ["run", "--config", str(config), "--synthetic", "--k-fold", str(k), "--model",
            "fusion_moddrop", "--output-dir", str(out)]
    impl, calls = tt.minibatch_moddrop_impl, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trained = impl(*a, **kw)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, a, kw))
        return trained

    ap.reset_launch_counts()
    tt.minibatch_moddrop_impl = timed
    try:
        t0 = time.perf_counter()
        cli.main(args)
        wall = time.perf_counter() - t0
    finally:
        tt.minibatch_moddrop_impl = impl
    launches = dict(ap.launch_counts)
    if launches != {"kernel": 0, "plain": 0}:
        raise RuntimeError(f"the tabular CV launched K1: {launches}")
    names = ["results_aggregated.yaml", "fold_assignments.csv", "summary_table.csv"]
    names += [f"results_fold_{i}.yaml" for i in range(1, k + 1)]
    names += [f"preds_fold_{i}_full_observation.csv" for i in range(1, k + 1)]
    require_files(out, names, f"the {k}-fold tabular CV")
    agg = yaml.safe_load((out / "results_aggregated.yaml").read_text())
    if len(agg) != 6:
        raise RuntimeError(f"results_aggregated.yaml holds {len(agg)} scenarios, not 6")
    auc = agg["full_observation"]["roc_auc"]["mean"]
    if not math.isfinite(auc):
        raise RuntimeError(f"the {k}-fold tabular CV's ROC-AUC is {auc}")
    (trainer_s, a, kw), = calls
    steps = _steps(a)
    return {"wall_s": wall, "auc": auc, "aggregated": agg, "args": args, "launches": launches,
            "trainer_s": trainer_s, "steps": steps, "call": (a, kw)}


def _steps(a):
    """Training steps of a ``minibatch_moddrop_impl`` call: epochs x batches."""
    X, epochs, batch_size = a[1], a[7], a[8]
    return epochs * -(-X.shape[1] // batch_size)


def trainer_window(torch, call, epochs=2, top=8):
    """The trainer call of a CV run, again for ``epochs`` epochs under
    ``torch.profiler``. -> (steps, wall ms, device ms, kernel launches, top
    device ops). One stream, so device ms / wall is its busy share."""
    from pd_fusion_torch.nn.trainer import minibatch_moddrop_impl

    a, kw = call
    a = a[:7] + (epochs,) + a[8:]
    minibatch_moddrop_impl(*a, **kw)  # warm-up
    torch.cuda.synchronize()
    wall_ms, prof = profiled(torch, lambda: minibatch_moddrop_impl(*a, **kw))
    on_device = device_rows(torch, prof.key_averages())
    on_device.sort(key=_dev_ms, reverse=True)
    kernels = sum(e.count for e in on_device)
    if kernels == 0:
        raise RuntimeError("the trainer window shows no kernel")
    return (_steps(a), wall_ms, sum(_dev_ms(e) for e in on_device), kernels,
            [(e.key[:70], _dev_ms(e), e.count) for e in on_device[:top]])


def profile_cv(torch, cli, args, out: Path):
    """The whole CV once more under ``torch.profiler`` -> (wall ms, busy ms)."""
    wall_ms, prof = profiled(torch, lambda: cli.main(args[:-1] + [str(out)]))
    return wall_ms, busy(torch, prof.key_averages(), wall_ms)[0]


def scaled_config(yaml, tmp: Path, n: int) -> Path:
    """A copy of configs/quickstart.yaml whose data_config is a copy of
    configs/data_ppmi.yaml with ``num_samples: n``."""
    data_cfg = yaml.safe_load((ROOT / "configs" / "data_ppmi.yaml").read_text())
    data_cfg["synthetic"]["num_samples"] = n
    (tmp / f"data_{n}.yaml").write_text(yaml.safe_dump(data_cfg))
    cfg = yaml.safe_load(QUICKSTART.read_text())
    cfg["data_config"] = str(tmp / f"data_{n}.yaml")
    path = tmp / f"quickstart_{n}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def compare_kernels(torch, ap, checks, other, floor_ms):
    """``other`` (a K1 source with the first C interface) and K1, each
    checked against the plain version, then timed in turns (other, K1, K1,
    other) at each of ``TIMED_SHAPES``."""
    rows = {}
    for B, L, H in TIMED_SHAPES:
        scores, mask, h = checks.pool_inputs(B, L, H, (0,), seed=98, device="cuda")
        pooled = torch.empty(B, H, device="cuda")
        weights = torch.empty(B, L, device="cuda")
        other(scores, mask, h, pooled, weights)
        want_p, want_w = ap.attention_pool_reference(scores, mask, h)
        torch.cuda.synchronize()
        torch.testing.assert_close(pooled, want_p, atol=checks.POOL_ATOL, rtol=checks.POOL_RTOL)
        torch.testing.assert_close(weights, want_w, atol=checks.WEIGHTS_ATOL, rtol=0)
        times = time_in_turns(torch, {
            "other": lambda: other(scores, mask, h, pooled, weights),
            "k1": lambda: ap.attention_pool_forward(scores, mask, h)})
        o, k = (sum(times[n]) / 2 for n in ("other", "k1"))
        bound = pool_bound(B, L, H)[1][0]
        rows[(B, L, H)] = {"other_ms": o, "k1_ms": k}
        print(f"compare B={B} L={L} H={H} (device, in turns other,K1,K1,other): other "
              f"{times['other'][0]:.6f}/{times['other'][1]:.6f} ms, K1 {times['k1'][0]:.6f}/"
              f"{times['k1'][1]:.6f} ms; mean other {o:.6f} K1 {k:.6f} (K1/other {k / o:.4f}); "
              f"bound {bound:.6f} ms, launch floor {floor_ms:.6f} ms")
    return rows


# ---------------------------------------------------------------------------
# the calibrated, MoE and GBDT paths (phases 9-12)
# ---------------------------------------------------------------------------

CAL_BAND = 2e-3  # device against host isotonic, per fold (tests/test_cv_extras.py:330)
CAL_SCENS = ("full_observation", "no_mri", "clinical_only")
CAL_METRICS = ("roc_auc", "ece", "brier_score")
ISO_SHAPES = ((5, 100), (10, 4096))  # (K, Nc): the bench frame's folds; MAX_DEVICE_N at K=10
GBDT_HP = dict(n_rounds=100, depth=5, lr=0.1, lam=0.0, min_child_weight=1e-3,
               min_child_samples=20.0)  # configs/model_unimodal.yaml on DeviceHistGBDT's defaults
GBDT_HIST_RANGE = "GBDT level histograms (nn/gbdt.py::_histograms)"
DEV = "cuda"


@contextlib.contextmanager
def captured(module, name, calls):
    """Record the arguments of every call of ``module.name`` in ``calls``."""
    fn = getattr(module, name)

    def wrapper(*a, **kw):
        calls.append((a, kw))
        return fn(*a, **kw)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def ranged(torch, module, name, label):
    """``module.name`` inside a ``record_function`` range named ``label``."""
    fn = getattr(module, name)

    def wrapper(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def program_profile(torch, fn, steps=1, calls=1):
    """One device program as the main path calls it: its host wall per step
    unprofiled (synchronised at both ends, after a warm-up call), then
    ``calls`` calls under ``torch.profiler``: device ms and kernel launches
    per step. -> dict."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    wall_ms, prof = profiled(torch, lambda: [fn() for _ in range(calls)])
    rows = device_rows(torch, prof.key_averages())
    n = calls * steps
    return {"host_us_per_step": host_ms / steps * 1e3,
            "device_us_per_step": sum(_dev_ms(e) for e in rows) / n * 1e3,
            "launches_per_step": sum(e.count for e in rows) / n, "steps": steps,
            "busy_share": sum(_dev_ms(e) for e in rows) / wall_ms, "prof": prof}


def print_program(name, rec):
    print(f"  program {name}: {rec['steps']} step(s), host {rec['host_us_per_step']:.1f} us a step "
          f"(unprofiled), device {rec['device_us_per_step']:.1f} us a step, "
          f"{rec['launches_per_step']:.1f} launches a step, busy share under the profiler "
          f"{rec['busy_share']:.4f}")


def cv_config(yaml, tmp: Path, name, **extra) -> Path:
    """A copy of configs/quickstart.yaml with ``extra`` keys."""
    cfg = yaml.safe_load(QUICKSTART.read_text())
    cfg.update(extra)
    path = tmp / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def run_cli_cv(yaml, ap, cli, config: Path, model, out: Path, k=5):
    """One CV run through the CLI: wall, aggregated and per-fold results,
    with K1 launched neither as kernel nor plain."""
    ap.reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(["run", "--config", str(config), "--synthetic", "--k-fold", str(k), "--model", model,
              "--output-dir", str(out)])
    wall = time.perf_counter() - t0
    if dict(ap.launch_counts) != {"kernel": 0, "plain": 0}:
        raise RuntimeError(f"the {model} CV launched K1: {ap.launch_counts}")
    names = ["results_aggregated.yaml", "fold_assignments.csv", "summary_table.csv"]
    names += [f"results_fold_{i}.yaml" for i in range(1, k + 1)]
    names += [f"preds_fold_{i}_full_observation.csv" for i in range(1, k + 1)]
    require_files(out, names, f"the {k}-fold {model} CV")
    agg = yaml.safe_load((out / "results_aggregated.yaml").read_text())
    if len(agg) != 6:
        raise RuntimeError(f"the {model} CV's results_aggregated.yaml holds {len(agg)} scenarios")
    auc = agg["full_observation"]["roc_auc"]["mean"]
    if not (math.isfinite(auc) and auc > 0.6):
        raise RuntimeError(f"the {model} CV's ROC-AUC {auc} is not finite and > 0.6")
    folds = [yaml.safe_load((out / f"results_fold_{i}.yaml").read_text()) for i in range(1, k + 1)]
    return {"wall_s": wall, "auc": auc, "auc_std": agg["full_observation"]["roc_auc"]["std"],
            "folds": folds}


def check_isotonic(torch, np):
    """Device isotonic against the host fit on the shared sets, then timed
    at the CV shapes with its peak memory."""
    from pd_fusion_torch.ops import isotonic_checks as ic
    from pd_fusion_torch.ops.isotonic import isotonic_fit_transform

    n_sets, n_equal = ic.check_all(DEV)
    print(f"device isotonic vs the host fit ({n_sets} sets: 12 random, every other tie-heavy, and "
          f"12 quantized): identical tie classes in all, bitwise equal in {n_equal}, the rest "
          f"within {ic.ULP:.3e}")
    recs = {}
    for K, n in ISO_SHAPES:
        args = ic.fold_batched_inputs(K, n, device=DEV)
        isotonic_fit_transform(*args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        isotonic_fit_transform(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        rec = program_profile(torch, lambda: isotonic_fit_transform(*args))
        rec["peak_mb"] = peak / 2**20
        print(f"device isotonic K={K} Nc={n} (t of 6 Nc points a fold): peak {rec['peak_mb']:.1f} MiB "
              f"above its inputs")
        print_program(f"isotonic K={K} Nc={n}", rec)
        recs[(K, n)] = rec
    return n_sets, n_equal, recs


def check_calibrated_frames(yaml, ap, cli, tmp: Path):
    """The bench CV frame with ``calibrate: true``, val-calibrated and
    nested, each on the device arm and under PD_FUSION_HOST_ISOTONIC=1:
    per-fold metrics within CAL_BAND, and the arm counters show which ran."""
    import os

    from pd_fusion_torch.parallel import cv_engine

    paths = []
    for name, extra in (("cv5_calibrated", {"calibrate": True}),
                        ("cv5_nested", {"calibrate": True, "nested_calibration": True})):
        config = cv_config(yaml, tmp, name, **extra)
        runs = {}
        for arm in ("device", "host"):
            before = dict(cv_engine.isotonic_arms)
            if arm == "host":
                os.environ["PD_FUSION_HOST_ISOTONIC"] = "1"
            try:
                runs[arm] = run_cli_cv(yaml, ap, cli, config, "fusion_moddrop", tmp / f"{name}_{arm}")
            finally:
                os.environ.pop("PD_FUSION_HOST_ISOTONIC", None)
            moved = {a: cv_engine.isotonic_arms[a] - before[a] for a in before}
            if moved != {arm: 1, ("host" if arm == "device" else "device"): 0}:
                raise RuntimeError(f"{name}: the {arm} arm did not run alone: {moved}")
            runs[arm]["arms"] = moved
        err = max(abs(a[s][m] - b[s][m]) for a, b in zip(runs["device"]["folds"], runs["host"]["folds"])
                  for s in CAL_SCENS for m in CAL_METRICS)
        if not err <= CAL_BAND:
            raise RuntimeError(f"{name}: device and host isotonic differ by {err} > {CAL_BAND}")
        print(f"{name} (fusion_moddrop, bench frame, calibrate: true{', nested' if 'nested' in name else ''}): "
              f"device arm wall {runs['device']['wall_s']:.3f} s (isotonic arm counters moved "
              f"{runs['device']['arms']}), host arm wall {runs['host']['wall_s']:.3f} s (moved "
              f"{runs['host']['arms']}); per-fold metrics max abs difference {err:.3e} (band "
              f"{CAL_BAND}); full_observation ROC-AUC {runs['device']['auc']:.4f} +- "
              f"{runs['device']['auc_std']:.4f}")
        paths.append({"name": f"tabular_{name}", "wall_s": runs["device"]["wall_s"],
                      "host_arm_wall_s": runs["host"]["wall_s"], "auc": runs["device"]["auc"],
                      "device_vs_host_max_err": err, "isotonic_arm": "device"})
    return paths


def check_moe(torch, yaml, ap, cli, tmp: Path):
    """The MoE: the fold-batched trainer card vs CPU, the 5-fold CV
    calibrated and not (its trainer under the profiler), the quickstart
    and its evaluate round trip."""
    from pd_fusion_torch.nn import moe as moe_mod
    from pd_fusion_torch.nn import trainer_checks as tc

    inputs = tc.moe_inputs()
    err_p, err_y, t_card, t_cpu = tc.compare_moe_card_with_cpu(inputs, device=DEV)
    print(f"MoE fold-batched trainer card vs CPU (K=5 n=400, experts [32, 16], router [16], 50 "
          f"full-batch epochs, one init): params max abs err {err_p:.3e} (atol {tc.MOE_ATOL[0]}), "
          f"probs {err_y:.3e} (atol {tc.MOE_ATOL[1]}); wall card {t_card:.3f} s, CPU {t_cpu:.3f} s")
    paths, programs = [], {}
    for name, extra in (("moe_cv5", {}), ("moe_cv5_calibrated", {"calibrate": True})):
        calls = []
        with captured(moe_mod, "train_moe_folds", calls):
            cv = run_cli_cv(yaml, ap, cli, cv_config(yaml, tmp, name, **extra), "moe", tmp / name)
        (a, kw), = calls
        rec = program_profile(torch, lambda: moe_mod.train_moe_folds(*a, **kw), steps=a[6])
        p_wall, prof = profiled(torch, lambda: cli.main(
            ["run", "--config", str(tmp / f"{name}.yaml"), "--synthetic", "--k-fold", "5", "--model",
             "moe", "--output-dir", str(tmp / f"{name}_prof")]))
        busy_ms, share = busy(torch, prof.key_averages(), p_wall)
        print(f"{name} (configs/model_moe.yaml, bench frame): wall {cv['wall_s']:.3f} s, "
              f"full_observation ROC-AUC {cv['auc']:.4f} +- {cv['auc_std']:.4f}, K1 launches 0; "
              f"the whole CV under torch.profiler busy {busy_ms:.3f} of {p_wall:.3f} ms "
              f"(share {share:.4f})")
        print_program("MoE fold-batched trainer (forward, backward, Adam a step)", rec)
        programs[name] = rec
        paths.append({"name": name, "wall_s": cv["wall_s"], "auc": cv["auc"], "busy_share": share,
                      "steps": rec["steps"], "launches_per_step": rec["launches_per_step"],
                      "device_us_per_step": rec["device_us_per_step"],
                      "host_us_per_step": rec["host_us_per_step"]})
    q = run_single(yaml, ap, cli, tmp, "moe")
    paths.append({"name": "moe_quickstart", "wall_s": q["wall_s"], "auc": q["auc"]})
    return paths, programs


def run_single(yaml, ap, cli, tmp: Path, model):
    """The single-split quickstart with ``--model``, then ``evaluate
    --run-dir``: its deterministic scenarios to 1e-6."""
    out = tmp / f"single_{model}"
    ap.reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(["run", "--config", str(QUICKSTART), "--synthetic", "--model", model,
              "--output-dir", str(out)])
    wall = time.perf_counter() - t0
    if dict(ap.launch_counts) != {"kernel": 0, "plain": 0}:
        raise RuntimeError(f"the {model} quickstart launched K1: {ap.launch_counts}")
    require_files(out, ["model.pt", "preprocess.pkl", "results.yaml"] + plot_files(PLOTS),
                  f"the {model} quickstart")
    results = yaml.safe_load((out / "results.yaml").read_text())
    cli.main(["evaluate", "--config", str(EVAL_CONFIG), "--run-dir", str(out)])
    again = yaml.safe_load((out / "results_eval.yaml").read_text())
    err = max(abs(again[s][m] - v) for s in DETERMINISTIC_SCENARIOS for m, v in results[s].items())
    if not err <= 1e-6:
        raise RuntimeError(f"{model}: evaluate --run-dir differs from the run by {err}")
    auc = results["full_observation"]["roc_auc"]
    print(f"quickstart --model {model}: wall {wall:.3f} s, full_observation ROC-AUC {auc:.4f}, "
          f"evaluate --run-dir matches results.yaml to {err:.1e}")
    return {"wall_s": wall, "auc": auc}


def check_gbdt(torch, np, yaml, ap, cli, tmp: Path):
    """The device GBDT: determinism, card vs CPU with the audit, fold
    batching, both lowerings per round, the CV calibrated and not, the
    quickstart, predict_margin and TreeSHAP."""
    from pd_fusion_torch.nn import gbdt as G
    from pd_fusion_torch.nn import gbdt_checks as gc

    bins, y, w, base = gc.cv_like_inputs()  # K=5 n=400 F=10: the bench frame's clinical folds
    hp = dict(GBDT_HP, hist_mode=G.resolve_hist_mode("auto"))
    if hp["hist_mode"] != "onehot":
        raise RuntimeError(f"hist_mode auto resolved to {hp['hist_mode']} on the card")
    gc.check_two_fits_identical(bins, y, w, base, hp, DEV)
    same = gc.check_fold_batched_equals_per_fold(bins, y, w, base, hp, DEV)
    if not same:
        raise RuntimeError("the fold-batched GBDT fit is not bit-identical to the per-fold fits")
    print(f"GBDT (K=5 n=400 F=10, 100 trees depth 5): hist_mode auto -> onehot; two fits on the "
          f"card bit-identical; the fold-batched fit bit-identical to 5 per-fold fits")
    repeat_scatter = gc.bitwise_equal(gc.fit(bins, y, w, base, dict(hp, hist_mode="scatter"), DEV),
                                      gc.fit(bins, y, w, base, dict(hp, hist_mode="scatter"), DEV))
    print(f"  scatter (index_add_, float atomics): two fits bit-identical: {repeat_scatter}")
    small = dict(hp, n_rounds=30)
    for mode in ("onehot", "scatter"):
        equal, first, leaf_err = gc.compare_card_with_cpu(bins[0], y[0], w[0], base[0],
                                                          dict(small, hist_mode=mode), DEV)
        print(f"  card vs CPU ({mode}, fold 1, 30 trees): "
              + ("trees equal" if equal else f"first differing tree {first}, both pass the "
                 f"float32 split-optimality audit") + f"; leaf max abs err before it {leaf_err:.3e}")

    programs = {}
    t = lambda a: torch.as_tensor(a, device=DEV)  # noqa: E731
    tb, ty, tw, tbase = t(bins), t(y), t(w), t(base)
    for mode in ("onehot", "scatter"):
        rounds = 10
        fit = lambda: G.train_gbdt(tb, ty, tw, tbase, **dict(hp, n_rounds=rounds, hist_mode=mode))  # noqa: E731,B023
        with ranged(torch, G, "_histograms", GBDT_HIST_RANGE):
            rec = program_profile(torch, fit, steps=rounds)
        calls, hist_ms, hist_n = range_device(torch, rec["prof"], GBDT_HIST_RANGE)
        rec["hist_device_us_per_step"] = hist_ms / rounds * 1e3
        rec["hist_launches_per_step"] = hist_n / rounds
        print_program(f"GBDT round ({mode}, K=5 folds at once)", rec)
        print(f"    of which the {calls // rounds} level histograms: device "
              f"{rec['hist_device_us_per_step']:.1f} us, {rec['hist_launches_per_step']:.1f} "
              f"launches a round; the rest {rec['device_us_per_step'] - rec['hist_device_us_per_step']:.1f} us")
        programs[f"gbdt_round_{mode}"] = rec

    paths = []
    for name, extra in (("gbdt_cv5", {}), ("gbdt_cv5_calibrated", {"calibrate": True})):
        pm_calls = []
        with captured(G, "predict_margin", pm_calls):
            cv = run_cli_cv(yaml, ap, cli, cv_config(yaml, tmp, name, **extra), "unimodal_clinical",
                            tmp / name)
        print(f"{name} (--model unimodal_clinical: configs/model_unimodal.yaml on the device "
              f"backend): wall {cv['wall_s']:.3f} s, full_observation ROC-AUC {cv['auc']:.4f} +- "
              f"{cv['auc_std']:.4f}, K1 launches 0")
        paths.append({"name": name, "wall_s": cv["wall_s"], "auc": cv["auc"]})
    (a, kw), = pm_calls
    rec = program_profile(torch, lambda: G.predict_margin(*a, **kw), calls=5)
    print_program(f"predict_margin (100 trees, bins {list(a[1].shape)})", rec)
    programs["predict_margin"] = rec
    q = run_single(yaml, ap, cli, tmp, "unimodal_clinical")
    paths.append({"name": "gbdt_quickstart", "wall_s": q["wall_s"], "auc": q["auc"]})

    trees = gc.fit(bins[0], y[0], w[0], base[0], hp, DEV)
    err, add, t_card, t_cpu = gc.compare_shap_card_with_cpu(trees, bins[0], base[0], hp["depth"],
                                                            DEV)
    print(f"TreeSHAP (100 trees depth 5, 400 rows in 2 chunks) card vs CPU: max abs err {err:.3e} "
          f"(atol {gc.SHAP_ATOL}); additivity sum(phi) + E - margin {add:.3e} (atol "
          f"{gc.ADDITIVITY_ATOL}); wall card {t_card:.3f} s, CPU {t_cpu:.3f} s")
    from pd_fusion_torch.ops import treeshap as TS

    td = {k: t(v) for k, v in trees.items()}
    chunk = t(bins[0][: TS._CHUNK]).long()
    rec = program_profile(torch, lambda: TS._shap_chunk(td, chunk, hp["depth"], bins.shape[2]))
    print_program(f"TreeSHAP chunk ({TS._CHUNK} rows, 100 trees depth 5)", rec)
    programs["treeshap_chunk"] = rec
    return paths, programs


# ---------------------------------------------------------------------------
# the imaging embed path (phases 13-19)
# ---------------------------------------------------------------------------

H100_BF16_FLOPS = 989e12  # dense bf16 tensor cores, H100 SXM data sheet
H100_TF32_FLOPS = 495e12
EMBED_SUBJECTS = 48  # x 2 sessions = 96 volumes
VOLUME_SHAPE = (176, 256, 256)  # a brain-extracted T1w at 1 mm, int16
VOLUME_SLOPE = 0.5
FLUSH_WIDTHS = (4, 8, 16, 32)
TTA_SUBJECTS = 8  # phase 19: 8 subjects x 2 sessions through the 3-axis TTA bags
MIL_DATA = ROOT / "configs" / "data_openneuro_ds001907_resnet2d_mil.yaml"
RESNET2D_CONFIG = ROOT / "configs" / "openneuro_ds001907_resnet2d.yaml"
MULTI_CONFIG = ROOT / "configs" / "openneuro_ds001907_resnet2d_mil_multi.yaml"


def script_argv(emb_cfg, manifest: Path, out_dir: Path, multi_axis_flags=True):
    """The builder script's flags for a data config's ``resnet2d_config``."""
    argv = ["--manifest", str(manifest), "--out-dir", str(out_dir),
            "--backbone", emb_cfg["backbone"],
            "--target-shape", *map(str, emb_cfg["target_shape"]),
            "--input-size", str(emb_cfg["input_size"]), "--batch-size", str(emb_cfg["batch_size"]),
            "--tta", str(emb_cfg["tta"]), "--max-rotation-deg", str(emb_cfg["max_rotation_deg"]),
            "--max-translation", str(emb_cfg["max_translation"]),
            "--intensity-scale", str(emb_cfg["intensity_scale"]),
            "--intensity-shift", str(emb_cfg["intensity_shift"]),
            "--noise-std", str(emb_cfg["noise_std"])]
    if "slice_axes" in emb_cfg:
        argv += ["--slice-axes", *map(str, emb_cfg["slice_axes"]),
                 "--slice-counts", *map(str, emb_cfg["slice_counts"])]
    else:
        argv += ["--slice-axis", str(emb_cfg["slice_axis"]),
                 "--slice-count", str(emb_cfg["slice_count"])]
    return argv


def data_config_copy(yaml, config: Path, tmp: Path, manifest: Path, cache: Path, name: str):
    """A copy of ``config`` whose data config points at ``manifest`` and
    ``cache``; the settings stay the repo's. -> (config path, the data
    config's resnet2d_config)."""
    cfg = yaml.safe_load(config.read_text())
    data_cfg = yaml.safe_load((ROOT / cfg["data_config"]).read_text())
    data_cfg.update(manifest_path=str(manifest), resnet2d_cache_dir=str(cache))
    (tmp / f"data_{name}.yaml").write_text(yaml.safe_dump(data_cfg))
    cfg["data_config"] = str(tmp / f"data_{name}.yaml")
    path = tmp / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path, data_cfg["resnet2d_config"]


@contextlib.contextmanager
def timed(torch, module, name, stages, key):
    """``module.name`` timed into ``stages[key]`` (seconds, synchronised)."""
    fn = getattr(module, name)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            torch.cuda.synchronize()
            stages[key] = stages.get(key, 0.0) + time.perf_counter() - t0

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def build_with_script(torch, script, argv, emb_cfg):
    """One run of a builder script (``main(argv)``), its config checked to
    be the data config's (so that the config's loader finds the artifact).
    -> (wall s, result, LAST_PROFILE with the run's stages: ``setup_s``
    (backbone init or load), ``pipeline_s`` and ``rest_s`` (writing the
    artifact), peak device bytes above those allocated before)."""
    from pd_fusion_torch.data import openneuro_features
    from pd_fusion_torch.imaging import pipeline

    if script.config_from_args(script.parse_args(argv)) != emb_cfg:
        raise RuntimeError(f"{script.__name__}: the flags do not give the data config {emb_cfg}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    stages = {}
    t0 = time.perf_counter()
    with timed(torch, openneuro_features, "_resnet_setup", stages, "setup_s"), \
            timed(torch, pipeline, "run_resnet_embedding_pipeline", stages, "pipeline_s"):
        out = script.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stages["rest_s"] = wall - stages["setup_s"] - stages["pipeline_s"]
    return (wall, out, {**pipeline.LAST_PROFILE, **stages},
            torch.cuda.max_memory_allocated() - base)


def embed_program(pipeline, size, folded, slices, mean, std, arch, per_slice=True):
    """The flush's device work as the pipeline issues it, on [W, L, h, w]
    float32 slices on the card, at ``size``^2 inputs."""
    return lambda: pipeline._embed(folded, slices, mean, std, arch, size, per_slice)


def embed_bound(flops, n_bytes, peak_flops):
    """Least time (us) for ``flops`` at ``peak_flops`` against ``n_bytes``
    (inputs read once, outputs written once) at HBM rate -> (us, bound by)."""
    t_ops = flops / peak_flops * 1e6
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e6
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def prep_slices(np, paths, target, axes, counts):
    """The native prep of ``paths`` on the host threads -> [n, L, h, w] float32."""
    from pd_fusion_torch.imaging.pipeline import VolumePrefetcher, make_slices_loader

    loader = make_slices_loader(target, axes, counts)
    return np.stack([v for _, v in VolumePrefetcher(paths, loader, depth=8)])


def run_embed_path(torch, np, yaml, ap, cli, tmp: Path):
    """Phases 14-19: synthetic volumes; ResNet-50 card vs CPU; the MIL bag
    builder at full width with its profile, flush widths and dtypes; the
    MIL CV on the built bags; the mean-pooled builder and its CV; the
    3-axis TTA bags. -> (paths, programs, K1 launches of the MIL CV)."""
    from pd_fusion_torch.imaging import embed_checks as ec
    from pd_fusion_torch.imaging import pipeline
    from pd_fusion_torch.nn.resnet import load_backbone, params_to
    from pd_fusion_torch.scripts import build_resnet2d_embeddings as mean_script
    from pd_fusion_torch.scripts import build_resnet2d_mil_embeddings as mil_script

    paths, programs = [], {}
    half = np.full(3, 0.5, np.float32)

    # phase 14: seeded synthetic volumes
    manifest, rows, write_s = ec.synthetic_t1w_dataset(
        tmp / "volumes", EMBED_SUBJECTS, shape=VOLUME_SHAPE, slope=VOLUME_SLOPE)
    gz = [r for r in rows if r["t1wbrain_path"].endswith(".gz")]
    sizes = [Path(r["t1wbrain_path"]).stat().st_size for r in rows]
    print(f"volumes: {len(rows)} ({len(gz)} .nii.gz at gzip level 1, {len(rows) - len(gz)} "
          f".nii), {VOLUME_SHAPE} int16, scl_slope {VOLUME_SLOPE}, {sum(sizes) / 2**30:.3f} GiB "
          f"on disk, written in {write_s:.3f} s; PD subjects {sum(r['label'] for r in gz)} of "
          f"{len(gz)}")

    mil_cfg = yaml.safe_load(MIL_DATA.read_text())["resnet2d_config"]
    target = tuple(mil_cfg["target_shape"])
    L = int(mil_cfg["slice_count"])
    size = int(mil_cfg["input_size"])

    # phase 15: ResNet-50 at full width, card against CPU on two volumes' slices
    params50, _, _ = load_backbone("resnet50", seed=0)
    two = prep_slices(np, [rows[0]["t1wbrain_path"], rows[1]["t1wbrain_path"]], target,
                      [mil_cfg["slice_axis"]], [L]).reshape(-1, *target[:2])
    t0 = time.perf_counter()
    cmp = ec.compare_card_with_cpu(params50, two, "resnet50", size, half, half, DEV)
    print(f"ResNet-50 ({size}^2, BN folded, random init seed 0) card vs CPU on {len(two)} slices of "
          f"two volumes: float32 (TF32 off) max abs err {cmp['max_abs_err']:.3e} of max "
          f"|emb| {cmp['scale']:.3e} (rel {cmp['rel_err']:.3e}, bound {ec.F32_REL}); bfloat16 "
          f"min cosine {cmp['bf16_min_cos']:.6f} (bound {ec.BF16_COS}), max abs err "
          f"{cmp['bf16_max_abs_err']:.3e}; {time.perf_counter() - t0:.3f} s")

    # phase 16: the MIL bag builder through the port's script, at full width
    cache = tmp / "embeddings_resnet2d"
    argv = script_argv(mil_cfg, manifest, cache)
    wall, bag_path, prof, peak = build_with_script(torch, mil_script, argv, mil_cfg)
    n_img = len(rows) * L
    print(f"MIL bag build (python -m pd_fusion_torch.scripts.build_resnet2d_mil_embeddings, "
          f"ResNet-50, {target}, axis {mil_cfg['slice_axis']}, {L} slices, {size}^2, float32, "
          f"{pipeline.SUBJECTS_PER_CALL} subjects a flush): wall {wall:.3f} s for {len(rows)} "
          f"volumes ({len(rows) / wall:.2f} volumes/s, {n_img / wall:.1f} images/s); "
          f"LAST_PROFILE {json.dumps({k: round(v, 6) for k, v in prof.items()})}; peak device "
          f"memory {peak / 2**30:.3f} GiB")
    with np.load(bag_path, allow_pickle=True) as bags:
        emb = bags["embeddings"]
        if emb.shape != (len(rows), L, 2048) or not np.isfinite(emb).all():
            raise RuntimeError(f"the MIL bags are {emb.shape}, finite {np.isfinite(emb).all()}")
    folded = pipeline.fold_backbone(params_to(params50, device=DEV), "resnet50")
    flops_img = ec.resnet_flops(folded, "resnet50", size)
    p_wall, prof_p = profiled(torch, lambda: mil_script.main(
        script_argv(mil_cfg, manifest, tmp / "embeddings_profiled")))
    rows_p = device_rows(torch, prof_p.key_averages())
    dev_ms = sum(_dev_ms(e) for e in rows_p)
    launches = sum(e.count for e in rows_p)
    tflops = flops_img * n_img / (dev_ms / 1e3) / 1e12
    print(f"  under torch.profiler: wall {p_wall:.3f} ms, device {dev_ms:.3f} ms (busy share "
          f"{dev_ms / p_wall:.4f}), {launches} device launches; {flops_img / 1e9:.3f} GFLOP an "
          f"image, {tflops:.2f} TFLOP/s over the device time ({tflops * 1e12 / H100_F32_FLOPS:.4f} "
          f"of the 67 TFLOP/s float32 peak, {tflops * 1e12 / H100_BF16_FLOPS:.4f} of 989 bf16)")
    rows_p.sort(key=_dev_ms, reverse=True)
    for e in rows_p[:6]:
        print(f"  {_dev_ms(e):10.3f} ms  x{e.count:<5d} {e.key[:70]}")

    # flush widths in turns: the device program alone, then the whole pipeline
    mean_t = torch.as_tensor(half, device=DEV)
    host32 = prep_slices(np, [r["t1wbrain_path"] for r in rows[:max(FLUSH_WIDTHS)]], target,
                         [mil_cfg["slice_axis"]], [L])
    on_card = torch.as_tensor(host32, device=DEV)
    warm_clocks(torch)
    per_width = {w: [] for w in FLUSH_WIDTHS}
    with torch.inference_mode():
        for order in (FLUSH_WIDTHS, FLUSH_WIDTHS[::-1]):
            for w in order:
                fn = embed_program(pipeline, size, folded, on_card[:w], mean_t, mean_t, "resnet50")
                fn()
                per_width[w].append(_median_event_ms(torch, fn, 3))
    ips = {w: w * L / (sum(t) / len(t) / 1e3) for w, t in per_width.items()}
    for w in FLUSH_WIDTHS:
        print(f"  flush width {w} ({w * L} images, float32): device {per_width[w][0]:.3f} / "
              f"{per_width[w][1]:.3f} ms in turns, {ips[w]:.1f} images/s, "
              f"{flops_img * ips[w] / 1e12:.2f} TFLOP/s")
    walls = {w: [] for w in FLUSH_WIDTHS}
    paths_in = [r["t1wbrain_path"] for r in rows]
    ids = [r["subject_id"] for r in rows]
    for order in (FLUSH_WIDTHS, FLUSH_WIDTHS[::-1]):
        for w in order:
            t0 = time.perf_counter()
            pipeline.run_resnet_embedding_pipeline(
                paths_in, ids, params50, half, half, arch="resnet50", target_shape=target,
                axes=[mil_cfg["slice_axis"]], counts=[L], input_size=size, per_slice=True,
                progress=False, subjects_per_call=w)
            walls[w].append(time.perf_counter() - t0)
    for w in FLUSH_WIDTHS:
        print(f"  flush width {w}: pipeline wall {walls[w][0]:.3f} / {walls[w][1]:.3f} s in turns "
              f"({len(rows) / (sum(walls[w]) / 2):.2f} volumes/s)")
    chosen = min(FLUSH_WIDTHS, key=lambda w: sum(walls[w]))
    print(f"  flush width with the least pipeline wall: {chosen}; with the most device images/s: "
          f"{max(FLUSH_WIDTHS, key=ips.get)}; SUBJECTS_PER_CALL is {pipeline.SUBJECTS_PER_CALL}")

    # compute dtypes at the pipeline's flush width, in turns: float32, bfloat16, TF32
    W = pipeline.SUBJECTS_PER_CALL
    x = on_card[:W]
    folded16 = pipeline.fold_backbone(params_to(params50, device=DEV), "resnet50", "bfloat16")

    def tf32():
        torch.backends.cudnn.allow_tf32 = True
        try:
            return pipeline._embed(folded, x, mean_t, mean_t, "resnet50", size, True)
        finally:
            torch.backends.cudnn.allow_tf32 = False

    arms = {"float32": embed_program(pipeline, size, folded, x, mean_t, mean_t, "resnet50"),
            "bfloat16": embed_program(pipeline, size, folded16, x, mean_t, mean_t, "resnet50"),
            "tf32": tf32}
    dtype_ms = {k: [] for k in arms}
    with torch.inference_mode():
        for order in (list(arms), list(arms)[::-1]):
            for k in order:
                arms[k]()
                dtype_ms[k].append(_median_event_ms(torch, arms[k], 3))
    peaks = {"float32": H100_F32_FLOPS, "bfloat16": H100_BF16_FLOPS, "tf32": H100_TF32_FLOPS}
    for k, t in dtype_ms.items():
        ms = sum(t) / 2
        print(f"  {k} at width {W}: device {t[0]:.3f} / {t[1]:.3f} ms in turns, "
              f"{W * L / ms * 1e3:.1f} images/s, {flops_img * W * L / ms / 1e9:.2f} "
              f"TFLOP/s ({flops_img * W * L / ms * 1e3 / peaks[k]:.4f} of its peak)")
    t0 = time.perf_counter()
    pipeline.run_resnet_embedding_pipeline(
        paths_in, ids, params50, half, half, arch="resnet50", target_shape=target,
        axes=[mil_cfg["slice_axis"]], counts=[L], input_size=size, per_slice=True, progress=False,
        compute_dtype="bfloat16")
    bf16_wall = time.perf_counter() - t0
    print(f"  bfloat16 pipeline: wall {bf16_wall:.3f} s ({len(rows) / bf16_wall:.2f} volumes/s); "
          f"LAST_PROFILE {json.dumps({k: round(v, 6) for k, v in pipeline.LAST_PROFILE.items()})}")

    # the device programs of a flush, each as the pipeline calls it
    xw = on_card[:W]
    weights = sum(t.numel() * 4 for _, t in _tensors(folded))
    for name, fold_tree, peak_flops in (("embed_resnet50_flush_f32", folded, H100_F32_FLOPS),
                                        ("embed_resnet50_flush_bf16", folded16, H100_BF16_FLOPS)):
        with torch.inference_mode():
            rec = program_profile(torch, embed_program(pipeline, size, fold_tree, xw, mean_t,
                                                       mean_t, "resnet50"))
        n = W * L
        rec["images"] = n
        rec["tflops"] = flops_img * n / (rec["device_us_per_step"] / 1e6) / 1e12
        rec["bound_us"], rec["bound_by"] = embed_bound(
            flops_img * n, xw.numel() * 4 + n * 2048 * 4 + weights // (2 if "bf16" in name else 1),
            peak_flops)
        print_program(f"{name} ({W} subjects x {L} slices)", rec)
        print(f"    {rec['tflops']:.2f} TFLOP/s; bound {rec['bound_us']:.1f} us ({rec['bound_by']})")
        programs[name] = rec
    from pd_fusion_torch.ops.image import slices_to_imagenet_batch

    flat = xw.reshape(-1, *target[:2])
    with torch.inference_mode():
        rec = program_profile(torch, lambda: slices_to_imagenet_batch(flat, size, mean_t, mean_t))
    rec["bound_us"] = (flat.numel() * 4 + flat.shape[0] * size * size * 3 * 4) / H100_BYTES_PER_S * 1e6
    rec["bound_by"] = "bytes"
    print_program(f"imagenet batch ({flat.shape[0]} slices {target[0]}^2 -> {size}^2 x 3)", rec)
    programs["imagenet_batch"] = rec

    # phase 17: the MIL CV on the bags the port built
    config, data_emb = data_config_copy(yaml, MIL_CONFIG, tmp, manifest, cache, "mil_built")
    if data_emb != mil_cfg:
        raise RuntimeError("the MIL config copy's embedding settings differ from the data config")
    out = tmp / "mil_built_run"
    ap.reset_launch_counts()
    t0 = time.perf_counter()
    agg = cli.main(["run", "--config", str(config), "--output-dir", str(out)])
    mil_wall = time.perf_counter() - t0
    k1 = dict(ap.launch_counts)
    k = yaml.safe_load(config.read_text())["cv_folds"]
    names = ["results_aggregated.yaml", "fold_assignments.csv", "summary_table.csv"]
    names += [f"results_fold_{i}.yaml" for i in range(1, k + 1)]
    require_files(out, names + plot_files(PLOTS, "_fold1"), "the MIL CV on built bags")
    on_disk = yaml.safe_load((out / "results_aggregated.yaml").read_text())
    if len(on_disk) != 7 or set(on_disk) != set(agg):
        raise RuntimeError("the MIL CV on built bags does not hold the 7 scenarios")
    if k1["kernel"] <= 0 or k1["plain"] != 0:
        raise RuntimeError(f"the MIL CV on built bags: K1 launches {k1}")
    mil_auc = on_disk["full_observation"]["roc_auc"]["mean"]
    if not math.isfinite(mil_auc):
        raise RuntimeError(f"the MIL CV on built bags: ROC-AUC {mil_auc}")
    print(f"MIL CV on the built bags ({k}-fold, configs/openneuro_ds001907_resnet2d_mil.yaml): "
          f"wall {mil_wall:.3f} s, K1 launches {k1['kernel']}, plain 0, full_observation ROC-AUC "
          f"{mil_auc:.4f} +- {on_disk['full_observation']['roc_auc']['std']:.4f} (not checked "
          f"against a band: random backbone, synthetic volumes)")

    paths.append({"name": "embed_mil_bags", "volumes": len(rows), "images": n_img, "wall_s": wall,
                  "volumes_per_s": len(rows) / wall, "images_per_s": n_img / wall,
                  "busy_share": dev_ms / p_wall, "device_ms": dev_ms, "tflops": tflops,
                  "peak_gib": peak / 2**30, "flush_width": pipeline.SUBJECTS_PER_CALL,
                  "chosen_width": chosen, "bf16_wall_s": bf16_wall,
                  "write_s": write_s, **{f"profile_{k}": v for k, v in prof.items()}})
    paths.append({"name": "mil_cv_built_bags", "wall_s": mil_wall, "auc": mil_auc,
                  "k1_launches": k1["kernel"]})

    # phase 18: the mean-pooled builder (ResNet-18, 24 slices) and its CV
    config, mean_cfg = data_config_copy(yaml, RESNET2D_CONFIG, tmp, manifest, cache, "resnet2d")
    wall18, df, prof18, peak18 = build_with_script(
        torch, mean_script, script_argv(mean_cfg, manifest, cache), mean_cfg)
    cols = [c for c in df.columns if c.startswith("mri_resnet_")]
    if len(df) != len(rows) or len(cols) != 512 or not np.isfinite(df[cols].to_numpy()).all():
        raise RuntimeError("the mean-pooled embeddings are not 512 finite columns a row")
    folded18 = pipeline.fold_backbone(params_to(load_backbone("resnet18")[0], device=DEV),
                                      "resnet18")
    with torch.inference_mode():
        rec = program_profile(torch, embed_program(pipeline, size, folded18,
                                                   on_card[:W, :mean_cfg["slice_count"]], mean_t,
                                                   mean_t, "resnet18", per_slice=False))
    n18 = W * mean_cfg["slice_count"]
    f18 = ec.resnet_flops(folded18, "resnet18", size)
    rec["images"] = n18
    rec["tflops"] = f18 * n18 / (rec["device_us_per_step"] / 1e6) / 1e12
    rec["bound_us"], rec["bound_by"] = embed_bound(
        f18 * n18, n18 * target[0] * target[1] * 4 + W * 512 * 4
        + sum(t.numel() * 4 for _, t in _tensors(folded18)), H100_F32_FLOPS)
    programs["embed_resnet18_flush_f32"] = rec
    print(f"mean-pooled build (ResNet-18, {mean_cfg['slice_count']} slices, "
          f"python -m pd_fusion_torch.scripts.build_resnet2d_embeddings): wall {wall18:.3f} s "
          f"({len(rows) / wall18:.2f} volumes/s); LAST_PROFILE "
          f"{json.dumps({k: round(v, 6) for k, v in prof18.items()})}; peak {peak18 / 2**30:.3f} GiB")
    print_program(f"embed_resnet18_flush_f32 ({W} subjects x {mean_cfg['slice_count']} slices)", rec)
    print(f"    {rec['tflops']:.2f} TFLOP/s; bound {rec['bound_us']:.1f} us ({rec['bound_by']})")
    out = tmp / "resnet2d_run"
    ap.reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(["run", "--config", str(config), "--output-dir", str(out)])
    cv_wall = time.perf_counter() - t0
    if dict(ap.launch_counts) != {"kernel": 0, "plain": 0}:
        raise RuntimeError(f"the resnet2d CV launched K1: {ap.launch_counts}")
    require_files(out, names, "the resnet2d CV")
    agg18 = yaml.safe_load((out / "results_aggregated.yaml").read_text())
    auc18 = agg18["full_observation"]["roc_auc"]["mean"]
    if len(agg18) != 7 or not math.isfinite(auc18):
        raise RuntimeError(f"the resnet2d CV: {len(agg18)} scenarios, ROC-AUC {auc18}")
    print(f"resnet2d CV (configs/openneuro_ds001907_resnet2d.yaml: fusion_moddrop, calibrated, "
          f"nested, 5-fold; clinical and DaT groups empty): wall {cv_wall:.3f} s, "
          f"full_observation ROC-AUC {auc18:.4f} +- {agg18['full_observation']['roc_auc']['std']:.4f}"
          f", K1 launches 0")
    paths.append({"name": "embed_resnet2d", "wall_s": wall18, "volumes_per_s": len(rows) / wall18,
                  "peak_gib": peak18 / 2**30})
    paths.append({"name": "resnet2d_cv", "wall_s": cv_wall, "auc": auc18})

    # phase 19: the 3-axis TTA bags on a subset, one volume card vs CPU
    multi_config, multi_cfg = data_config_copy(yaml, MULTI_CONFIG, tmp, manifest, cache, "multi")
    sub = rows[:2 * TTA_SUBJECTS]
    sub_manifest = tmp / "manifest_tta.csv"
    sub_manifest.write_text("\n".join(manifest.read_text().splitlines()[:1 + len(sub)]) + "\n")
    wall_tta, tta_path, prof_tta, peak_tta = build_with_script(
        torch, mil_script, script_argv(multi_cfg, sub_manifest, tmp / "tta"), multi_cfg)
    L3 = sum(multi_cfg["slice_counts"])
    with np.load(tta_path, allow_pickle=True) as bags:
        tta_emb = bags["embeddings"]
    if tta_emb.shape != (len(sub), L3, 2048) or not np.isfinite(tta_emb).all():
        raise RuntimeError(f"the TTA bags are {tta_emb.shape}")
    t0 = time.perf_counter()
    cpu = pipeline.run_resnet_embedding_pipeline(
        [sub[0]["t1wbrain_path"]], [sub[0]["subject_id"]], params50, half, half,
        arch="resnet50", target_shape=tuple(multi_cfg["target_shape"]),
        axes=multi_cfg["slice_axes"], counts=multi_cfg["slice_counts"], input_size=size,
        tta=multi_cfg["tta"], max_rotation=multi_cfg["max_rotation_deg"],
        max_translation=multi_cfg["max_translation"],
        intensity_scale=multi_cfg["intensity_scale"], intensity_shift=multi_cfg["intensity_shift"],
        noise_std=multi_cfg["noise_std"], per_slice=True, progress=False, device="cpu")[0]
    cpu_s = time.perf_counter() - t0
    scale = float(np.abs(cpu).max())
    err = float(np.abs(tta_emb[0] - cpu).max())
    if not err <= ec.F32_REL * scale:
        raise RuntimeError(f"TTA bag card vs CPU: max abs err {err:.3e} > {ec.F32_REL} x {scale:.3e}")
    print(f"3-axis TTA bags (configs/data_openneuro_ds001907_resnet2d_mil_multi.yaml: ResNet-50, "
          f"3 x {multi_cfg['slice_counts'][0]} slices, tta {multi_cfg['tta']}) on {len(sub)} "
          f"volumes: wall {wall_tta:.3f} s ({len(sub) / wall_tta:.2f} volumes/s), LAST_PROFILE "
          f"{json.dumps({k: round(v, 6) for k, v in prof_tta.items()})}, peak "
          f"{peak_tta / 2**30:.3f} GiB; volume 0 card vs CPU: max abs err {err:.3e} of max "
          f"|emb| {scale:.3e} (bound {ec.F32_REL} x), CPU {cpu_s:.3f} s")
    xt = on_card[:W, :L3 // 3].repeat(1, 3, 1, 1)
    draw = pipeline.tta_draws([r["subject_id"] for r in rows[:len(xt)]], 1, L3, *target[:2],
                              multi_cfg["max_rotation_deg"], multi_cfg["max_translation"],
                              multi_cfg["intensity_scale"], multi_cfg["intensity_shift"],
                              multi_cfg["noise_std"])[0]
    args = [torch.from_numpy(a).to(DEV) for a in draw]
    with torch.inference_mode():
        rec = program_profile(torch, lambda: pipeline._augment(xt, *args))
    rec["bound_us"] = 3 * xt.numel() * 4 / H100_BYTES_PER_S * 1e6  # slices, noise in; out
    rec["bound_by"] = "bytes"
    print_program(f"TTA affine + intensity + noise ({W} subjects x {L3} slices {target[0]}^2)", rec)
    programs["tta_affine"] = rec
    paths.append({"name": "embed_tta_multi_axis", "volumes": len(sub), "wall_s": wall_tta,
                  "volumes_per_s": len(sub) / wall_tta, "card_vs_cpu_max_abs_err": err,
                  "peak_gib": peak_tta / 2**30})
    return paths, programs, k1["kernel"]


def _tensors(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--compare-with", type=Path, default=None,
                        help="another attention_pool.cu with K1's first C interface, timed "
                             "against K1 in turns")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA device",
              file=sys.stderr)
        return 1
    import numpy as np
    import yaml

    from pd_fusion_torch import cli
    from pd_fusion_torch.ops import attention_pool as ap
    from pd_fusion_torch.ops import attention_pool_checks as checks
    from pd_fusion_torch.utils.device import get_device

    # phase 1: the card
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    get_device()  # sets full-f32 matmuls on the card

    # phase 2: build K1 from the repo's sources (and the source to compare
    # with), one nvcc each, and the host IO library (g++), all started together
    from pd_fusion_torch.imaging import native

    sources = [ap.SOURCE] + ([args.compare_with.resolve()] if args.compare_with else [])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        host_lib = pool.submit(native.build_library)
        libs = list(pool.map(ap.build_library, sources))
        host_lib = host_lib.result()
    print(f"build: {', '.join(map(str, libs + [host_lib]))} in {time.perf_counter() - t0:.2f} s")
    for src, lib in zip(sources, libs):
        log = lib.with_suffix(".log").read_text().strip()
        print(f"-Xptxas=-v for {src}:\n{log}")
    check_spills(libs[0].with_suffix(".log").read_text())

    # phase 3: kernel against plain on the card, then timed
    max_err = 0.0
    for i, (B, L, H, masked, off) in enumerate(checks.SHAPES):
        err = max(checks.check_forward(B, L, H, masked, seed=10 + i, h_offset=off),
                  checks.check_gradient(B, L, H, masked, seed=10 + i, h_offset=off))
        path = ap.launch_config(B, L, H, off % 4 == 0).path
        print(f"pool B={B} L={L} H={H} all-masked={list(masked)} h offset {4 * off} B "
              f"({path}): max abs err {err:.3e} (pooled and gradients "
              f"atol=rtol={checks.POOL_ATOL}, weights atol={checks.WEIGHTS_ATOL})")
        max_err = max(max_err, err)
    head_err = check_mil_head(torch, np)
    print(f"mil_apply D={EMB_DIM} H=256 attn=128 card vs CPU: max abs err {head_err:.3e}")

    warm_clocks(torch)
    floor_ms = launch_floor_ms(torch)
    print(f"launch floor (one-element zero_(), device, CUDA graph): {floor_ms:.6f} ms")
    timings = {}
    for B, L, H in TIMED_SHAPES + [LONG_BAG]:
        scores, mask, h = checks.pool_inputs(B, L, H, (0,), seed=99, device="cuda")
        kernel = lambda: ap.attention_pool_forward(scores, mask, h)  # noqa: E731
        plain = lambda: ap.attention_pool_reference(scores, mask, h)  # noqa: E731
        t = {"kernel_ms": time_device_ms(torch, kernel), "plain_ms": time_device_ms(torch, plain),
             "kernel_call_ms": time_call_ms(torch, kernel),
             "plain_call_ms": time_call_ms(torch, plain)}
        n_bytes, (t["bound_ms"], t["bound_by"]) = pool_bound(B, L, H)
        timings[(B, L, H)] = t
        print(f"timing B={B} L={L} H={H} (device, CUDA graph): kernel_ms {t['kernel_ms']:.6f} "
              f"plain_ms {t['plain_ms']:.6f} bound_ms {t['bound_ms']:.6f} ({t['bound_by']}) "
              f"bytes {n_bytes} launch_floor_ms {floor_ms:.6f}; per call with host work: "
              f"kernel {t['kernel_call_ms']:.6f} ms, plain {t['plain_call_ms']:.6f} ms "
              f"({ap.launch_config(B, L, H, True)})")

    if args.compare_with:
        other = bind_first_interface(torch, libs[1])
        warm_clocks(torch)
        compare_kernels(torch, ap, checks, other, floor_ms)

    wall_ms, busy_ms, top, (bwd_calls, bwd_ms, bwd_launches) = profile_trainer(torch, ap)
    print(f"trainer profile (2 epochs, 80 bags, D={EMB_DIM}, batch 16): wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms, busy share {busy_ms / wall_ms:.4f}")
    for name, ms, count in top:
        print(f"  {ms:10.3f} ms  x{count:<5d} {name}")
    if bwd_calls == 0 or bwd_launches == 0:
        raise RuntimeError("the trainer profile shows no K1 backward range or no kernel in it")
    print(f"  K1 backward (torch ops) range: {bwd_calls} calls, device {bwd_ms:.3f} ms "
          f"({bwd_ms / bwd_calls * 1e3:.3f} us a call, share of device busy "
          f"{bwd_ms / busy_ms:.4f}), {bwd_launches} kernel launches "
          f"({bwd_launches / bwd_calls:.1f} a call)")

    # phase 4: the ds001907 MIL CV slice at full width through the CLI; then
    # the same slice again under the profiler, for K1's measured part of it
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        res = run_slice(np, yaml, ap, cli, tmp)
        print(f"slice: {res['k']}-fold MIL CV wall {res['wall_s']:.2f} s, kernel launches "
              f"{res['launches']}, plain launches 0, full_observation ROC-AUC {res['auc']:.4f}")
        for scen, m in res["aggregated"].items():
            print(f"  {scen}: roc_auc {m['roc_auc']['mean']:.4f} +- {m['roc_auc']['std']:.4f}")
        p_wall, p_busy, k1_dev, k1_n, k1_host = profile_slice(
            torch, ap, cli, res["config_path"], tmp / "run_profiled")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"slice under torch.profiler: wall {p_wall:.3f} ms, device busy {p_busy:.3f} ms "
          f"(share {p_busy / p_wall:.4f}); K1 kernels {k1_n}, K1 device {k1_dev:.3f} ms "
          f"(share of device busy {k1_dev / p_busy:.4f}), K1 wrapper host {k1_host:.3f} ms "
          f"(share of wall {k1_host / p_wall:.4f})")
    t, t80 = timings[(16, 48, 256)], timings[(80, 48, 256)]
    paths = [{"name": "mil_cv", "wall_s": res["wall_s"], "busy_share": p_busy / p_wall,
              "auc": res["auc"]}]

    # phase 5: the tabular trainer and forward, card against CPU
    check_tabular_trainer(torch)

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tabular_"))
    try:
        # phase 6: the single-split quickstart through the CLI
        q = run_quickstart(torch, yaml, cli, tmp)
        ref, band = QUICKSTART_BAND
        print(f"quickstart (run --config {QUICKSTART} --synthetic): wall {q['wall_s']:.3f} s, "
              f"busy share {q['busy_share']:.4f}; evaluate --run-dir matches results.yaml to "
              f"{q['eval_err']:.1e} on {', '.join(DETERMINISTIC_SCENARIOS)}; seed 42's "
              f"full_observation ROC-AUC {q['auc']:.4f} (reference band {ref} +- {band}: "
              f"{'in' if abs(q['auc'] - ref) < band else 'out'})")
        for scen, m in q["results"].items():
            print(f"  {scen}: roc_auc {m['roc_auc']:.4f}")
        q_mean, q_sd, q_lim = check_quickstart_spread()
        print(f"quickstart over {QUICKSTART_DRAWS} generator chains on the card: ROC-AUC mean "
              f"{q_mean:.4f}, sd {q_sd:.4f}; the JAX package's over {JAX_QUICKSTART_AUC[2]} "
              f"chains {JAX_QUICKSTART_AUC[0]} (limit +- {q_lim:.4f})")
        paths.append({"name": "tabular_quickstart", "wall_s": q["wall_s"],
                      "busy_share": q["busy_share"], "auc": q["auc"],
                      "auc_mean_over_chains": q_mean})

        # phases 7 and 8: the bench CV frame and the scaled frame through the
        # CLI; the bench frame once more under the profiler; each one's
        # trainer call again for 2 epochs under the profiler
        big_config = scaled_config(yaml, tmp, 5000)
        for name, config, k in (("tabular_cv5", QUICKSTART, 5),
                                ("tabular_cv10_n5000", big_config, 10)):
            cv = run_tabular_cv(torch, yaml, ap, cli, config, k, tmp / name)
            if k == 5 and not cv["auc"] > CV_AUC_MIN:
                raise RuntimeError(f"5-fold CV ROC-AUC {cv['auc']} is not > {CV_AUC_MIN}")
            host_us = cv["trainer_s"] / cv["steps"] * 1e6
            print(f"{name} (fusion_moddrop, [64, 32], batch 32, 50 epochs): wall "
                  f"{cv['wall_s']:.3f} s, trainer {cv['trainer_s']:.3f} s for {cv['steps']} "
                  f"fold-batched steps ({host_us:.1f} us a step), K1 launches {cv['launches']}, "
                  f"full_observation ROC-AUC {cv['auc']:.4f}")
            for scen, m in cv["aggregated"].items():
                print(f"  {scen}: roc_auc {m['roc_auc']['mean']:.4f} +- "
                      f"{m['roc_auc']['std']:.4f}")
            w_steps, w_wall, w_dev, w_n, top = trainer_window(torch, cv["call"])
            dev_us = w_dev / w_steps * 1e3
            print(f"  trainer window under torch.profiler ({w_steps} steps): wall {w_wall:.3f} ms "
                  f"({w_wall / w_steps * 1e3:.1f} us a step), device {w_dev:.3f} ms ({dev_us:.1f} "
                  f"us a step, busy share {w_dev / w_wall:.4f}), {w_n} kernel launches "
                  f"({w_n / w_steps:.1f} a step)")
            for op, ms, count in top:
                print(f"  {ms:10.3f} ms  x{count:<6d} {op}")
            rec = {"name": name, "wall_s": cv["wall_s"], "auc": cv["auc"], "steps": cv["steps"],
                   "host_us_per_step": host_us, "device_us_per_step": dev_us,
                   "launches_per_step": w_n / w_steps}
            if k == 5:
                p_wall, p_busy = profile_cv(torch, cli, cv["args"], tmp / f"{name}_prof")
                print(f"  the whole CV under torch.profiler: wall {p_wall:.3f} ms, device busy "
                      f"{p_busy:.3f} ms (share {p_busy / p_wall:.4f})")
                rec["busy_share"] = p_busy / p_wall
            else:  # the whole run's profile takes minutes to read back
                rec["busy_share"] = w_dev / w_wall
                rec["busy_share_of"] = "the trainer window"
            paths.append(rec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # phases 9-12: device isotonic; the bench frame calibrated on the device
    # arm and on the host arm; the MoE; the device GBDT and TreeSHAP
    n_sets, n_equal, iso = check_isotonic(torch, np)
    paths.append({"name": "device_isotonic", "sets": n_sets, "bitwise_equal_sets": n_equal,
                  **{f"peak_mib_K{K}_Nc{n}": r["peak_mb"] for (K, n), r in iso.items()}})
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cal_moe_gbdt_"))
    try:
        paths += check_calibrated_frames(yaml, ap, cli, tmp)
        moe_paths, programs = check_moe(torch, yaml, ap, cli, tmp)
        gbdt_paths, gbdt_programs = check_gbdt(torch, np, yaml, ap, cli, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    paths += moe_paths + gbdt_paths
    programs.update({f"isotonic_K{K}_Nc{n}": r for (K, n), r in iso.items()}, **gbdt_programs)

    # phase 13: the host IO library the embed path runs on
    import os

    info = native.build_info()
    print(f"native pd_io: {info['path']}, inflate {info['inflate']}, built in "
          f"{info['build_s']:.2f} s (g++ -O3 -march=native); host cores "
          f"{len(os.sched_getaffinity(0))}; pyarrow "
          f"{'present' if importlib.util.find_spec('pyarrow') else 'absent'}")

    # phases 14-19: the imaging embed path, then the MIL CV on its bags
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_embed_"))
    try:
        embed_paths, embed_programs, built_launches = run_embed_path(torch, np, yaml, ap, cli, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    paths += embed_paths
    programs.update(embed_programs)

    # phase 20: the record (times at the training step's shape, and at B=80)
    print(json.dumps({"programs": [
        {"name": name, **{k: v for k, v in rec.items() if k != "prof"}}
        for name, rec in programs.items()]}))
    print(json.dumps({"paths": paths}))
    print(json.dumps({"kernels": [{
        "name": "attention_pool",
        "route": "cuda",
        "source": "src/pd_fusion_torch/csrc/attention_pool.cu",
        "replaces": "src/pd_fusion/ops/pallas_mil.py:26",
        "launches": res["launches"] + built_launches,
        "launches_by_path": {"mil_cv_synthetic_bags": res["launches"],
                             "mil_cv_built_bags": built_launches},
        "max_abs_err": max_err,
        "ms": t["kernel_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "shape": "B=16 L=48 H=256 f32",
        "call_ms": t["kernel_call_ms"],
        "plain_call_ms": t["plain_call_ms"],
        "slice_wall_s": res["wall_s"],
        "launch_floor_ms": floor_ms,
        "ms_b80": t80["kernel_ms"],
        "plain_ms_b80": t80["plain_ms"],
        "bound_ms_b80": t80["bound_ms"],
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
