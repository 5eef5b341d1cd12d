#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/pd_fusion_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py --compare-with <path of another attention_pool.cu>

Phases; any failure exits non-zero before the final line:
1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build kernel K1 (``csrc/attention_pool.cu``) from the repo's sources
   with nvcc (set-up time and the ``-Xptxas=-v`` report, printed; the
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
9. a JSON line with each path's wall time, busy share and AUC; one with
   each kernel's launches, error and times (B=16 and B=80, and the launch
   floor); the card line again; then ``{"ok": true, "device": {...}}`` as
   the last line.

Needs a CUDA device and the repo around it; it imports nothing of JAX.
"""
import argparse
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
    # with), one nvcc each, started together
    sources = [ap.SOURCE] + ([args.compare_with.resolve()] if args.compare_with else [])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(ap.build_library, sources))
    print(f"build: {', '.join(map(str, libs))} in {time.perf_counter() - t0:.2f} s")
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

    # phase 9: the record (times at the training step's shape, and at B=80)
    print(json.dumps({"paths": paths}))
    print(json.dumps({"kernels": [{
        "name": "attention_pool",
        "route": "cuda",
        "source": "src/pd_fusion_torch/csrc/attention_pool.cu",
        "replaces": "src/pd_fusion/ops/pallas_mil.py:26",
        "launches": res["launches"],
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
