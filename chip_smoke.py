#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/pd_fusion_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero before the final line:
1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build kernel K1 (``csrc/attention_pool.cu``) from the repo's sources
   with nvcc (set-up time, printed);
3. K1 against its plain PyTorch version on the card, forward and
   gradient (``pd_fusion_torch/ops/attention_pool_checks.py``, the checks
   the ``cuda``-marked tests run too), at the MIL CV path's shapes (B=16 training step, B=80
   evaluation width; L=48, H=256), a tail shape (L=13, H=100) and an
   all-masked bag; then both timed with CUDA events beside the bound:
   device time from CUDA-graph replays, and time per call with the host
   work (median of 200 calls after warm-up); the full-width MIL head
   (``mil_apply``, D=2048) on the card against the same head on the CPU;
   and a ``torch.profiler`` window over two epochs of the MIL trainer at
   full width: the device's busy share and its top kernels;
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
5. one JSON line with each kernel's launches, error and times, the card
   line again, then ``{"ok": true, "device": {...}}`` as the last line.

Needs a CUDA device and the repo around it; it imports nothing of JAX.
"""
import importlib.util
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
MIL_CONFIG = ROOT / "configs" / "openneuro_ds001907_resnet2d_mil.yaml"
N_SUBJECTS, N_SLICES, EMB_DIM = 48, 48, 2048


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


def profile_trainer(torch, n=80, epochs=2, top=6):
    """Where the MIL trainer's time goes at full width: ``epochs`` epochs of
    ``train_mil_impl`` on ``n`` bags (batch 16, the slice's settings) under
    ``torch.profiler``, after one warm-up epoch. -> (wall ms, summed device
    ms, top ops by device time). One stream, so device time / wall is the
    device's busy share."""
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

    run(1)
    torch.cuda.synchronize()
    wall_ms, rows = profiled(torch, lambda: run(epochs))
    on_device = device_rows(torch, rows)
    on_device.sort(key=_dev_ms, reverse=True)
    return (wall_ms, sum(_dev_ms(e) for e in on_device),
            [(e.key[:70], _dev_ms(e), e.count) for e in on_device[:top]])


def profiled(torch, fn):
    """``fn()`` under ``torch.profiler`` (host and device) -> (wall ms, key_averages)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, prof.key_averages()


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
        wall_ms, rows = profiled(torch, lambda: cli.main(
            ["run", "--config", str(config_path), "--output-dir", str(out_dir)]))
    finally:
        ap.attention_pool_forward = forward
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
    # the fold-1 plots: their CSV twins always, the PNGs where matplotlib is installed
    exts = ("csv", "png") if importlib.util.find_spec("matplotlib") else ("csv",)
    expected += [f"{p}_fold1.{ext}" for p in
                 ("degradation", "roc_curve", "pr_curve", "calibration", "risk_coverage")
                 for ext in exts]
    missing = [f for f in expected if not (out_dir / f).exists()]
    if missing:
        raise RuntimeError(f"slice run lacks artifacts: {missing}")
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


def main() -> int:
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

    # phase 2: build K1 from the repo's sources
    t0 = time.perf_counter()
    lib = ap.build_library()
    print(f"build: {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    print(lib.with_suffix(".log").read_text().strip())

    # phase 3: kernel against plain on the card, then timed
    max_err = 0.0
    for i, (B, L, H, masked) in enumerate(checks.SHAPES):
        err = max(checks.check_forward(B, L, H, masked, seed=10 + i),
                  checks.check_gradient(B, L, H, masked, seed=10 + i))
        print(f"pool B={B} L={L} H={H} all-masked={list(masked)}: max abs err {err:.3e} "
              f"(pooled and gradients atol=rtol={checks.POOL_ATOL}, "
              f"weights atol={checks.WEIGHTS_ATOL})")
        max_err = max(max_err, err)
    head_err = check_mil_head(torch, np)
    print(f"mil_apply D={EMB_DIM} H=256 attn=128 card vs CPU: max abs err {head_err:.3e}")

    timings = {}
    for B in (16, 80):
        scores, mask, h = checks.pool_inputs(B, 48, 256, (0,), seed=99, device="cuda")
        kernel = lambda: ap.attention_pool_forward(scores, mask, h)  # noqa: E731
        plain = lambda: ap.attention_pool_reference(scores, mask, h)  # noqa: E731
        t = {"kernel_ms": time_device_ms(torch, kernel), "plain_ms": time_device_ms(torch, plain),
             "kernel_call_ms": time_call_ms(torch, kernel),
             "plain_call_ms": time_call_ms(torch, plain)}
        n_bytes, (t["bound_ms"], t["bound_by"]) = pool_bound(B, 48, 256)
        timings[B] = t
        print(f"timing B={B} L=48 H=256 (device, CUDA graph): kernel_ms {t['kernel_ms']:.6f} "
              f"plain_ms {t['plain_ms']:.6f} bound_ms {t['bound_ms']:.6f} ({t['bound_by']}) "
              f"bytes {n_bytes}; per call with host work: kernel {t['kernel_call_ms']:.6f} ms, "
              f"plain {t['plain_call_ms']:.6f} ms")

    wall_ms, busy_ms, top = profile_trainer(torch)
    print(f"trainer profile (2 epochs, 80 bags, D={EMB_DIM}, batch 16): wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms, busy share {busy_ms / wall_ms:.4f}")
    for name, ms, count in top:
        print(f"  {ms:10.3f} ms  x{count:<5d} {name}")

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
    t = timings[16]

    # phase 5: the record (times at the training step's shape)
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
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
