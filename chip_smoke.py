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
20. one MIL fine-tune step (``models/mil_attention_finetune.py::ft_step``:
   ResNet-50 at 224^2 with train-mode BN, B=2, L=8, gated head 256/128,
   focal, a ragged row, dropout keeps given) on the card against the CPU
   from the same parameters and draws, with the gate at 0 and at 1
   (``pd_fusion_torch/models/ft_checks.py``, shared with the ``cuda``
   tests): loss, running statistics, Adam moments and counts, and each
   device's weights against its own Adam step;
21. the fine-tune step at the config's full width (B=4, L=64, 160^2 ->
   224^2), frozen and unfrozen, under ``torch.profiler``: device and host
   time, launches, busy share, the step's wall and enqueue time, peak
   device memory (blocks rematerialized), TFLOP/s against the float32
   bound, the top device ops, and K1's kernel (by its symbol) and its
   torch-op backward (a ``record_function`` range) with their share of the
   step;
22. the fine-tune CV through the CLI on a copy of
   ``configs/openneuro_ds001907_resnet2d_mil_ft.yaml`` at every width of
   the config, on 24 of phase 14's subjects x 2 sessions, 2 folds, 3 epochs
   with the gate opening after the first (the cuts are printed): 7
   scenarios, fold CSVs and plots, K1 launched and the plain pool never;
   then the single split (``results.yaml``, ``model.pt``), the artifact
   reloaded with ``load_model`` predicting as the trained model with
   ``tta_inference`` 1; and a predict chunk with TTA 4 profiled;
23. the simple 3-D statistics (``ops/volume_stats.py``) of 8 of phase 14's
   volumes at the feature config's width (96^3, 10 bins, grid 8) on the
   card against the CPU, ``extra_stats`` off and on
   (``pd_fusion_torch/ops/volume_stats_checks.py``, shared with the
   ``cuda`` tests: order statistics and histogram equal), then the batch
   timed (device and host time, launches, busy share) beside its bound by
   bytes;
24. one CNN3D training step (``nn/cnn3d.py``) at the data config's
   ``cnn_config`` (64^3, embedding 64, batch 8) on the card against the CPU
   from one init and batch (``nn/cnn3d_checks.py``: loss, Adam moments,
   each device's weights against its own Adam step, embeddings); the step
   timed there and at the runbook's width (96^3, 128, batch 4): device and
   host time, launches, busy share, peak memory, TFLOP/s against the float32
   bound; the embed forward of 96 volumes at 64^3;
25. the CNN3D builder (``python -m
   pd_fusion_torch.scripts.build_cnn3d_embeddings`` with the ``cnn_config``
   flags) on the 96 volumes: wall split into read, init, train, embed and
   write; then the CLI's 5-fold CV on a copy of
   ``configs/openneuro_ds001907_simple.yaml`` pointed at that manifest and
   cache (``feature_mode: cnn3d``): artifacts, the 7 scenarios, K1 launched
   neither as kernel nor plain;
26. the same CV with ``feature_mode: simple``: the features build on first
   load (wall split into feature build and CV);
27. ``run --config configs/quickstart.yaml --dataset uci_parkinsons --k-fold
   5`` on a seeded fixture file with UCI's columns, written under a
   temporary ``PD_FUSION_DEV_DATA_DIR`` (nothing fetched);
28. ``download-dev`` through the port's CLI in this process, with no
   ``openneuro`` CLI on PATH and ``urlopen`` refusing, on a base directory
   where the UCI files exist: it returns, nothing fetched, the manual
   instructions printed, K1 counted 0;
29. the PPMI suites' device programs on the card against the CPU
   (``pd_fusion_torch/analysis/tabular_checks.py``, shared with the
   ``cuda`` tests): the balanced logistic fit, the batched AUC screen, the
   permutation probes, ``TabularPrep`` against the sweep's transformer, and
   the GBDT arm's fold-batched fit against each model's own fit;
30. the PPMI study-data path on seeded synthetic study CSVs of 1,500 PD and
   HC subjects (plus 200 SWEDD and prodromal the label map drops) at the
   widths of PPMI's tables: ``python -m
   pd_fusion_torch.scripts.ppmi_build_dataset`` with
   ``configs/ppmi_studydata.yaml`` (data directories redirected, every other
   setting the config's), ``ppmi_train_tabular`` (5 seeds x 6 ablations x
   {logreg, lgbm, mlp}), ``ppmi_eval_report`` and ``ppmi_meaningful_suite``
   on the built baseline table, each through its ``main``: every artifact,
   finite metrics, each stage's wall time, K1 launched neither as kernel
   nor plain; then the suites' device programs at the widest ablation,
   profiled and between CUDA events, beside their bounds;
31. the fused MIL sweep (``parallel/seed_sweep.py::run_multi_seed_cv`` with
   ``mil_attention``) over phase 16's bags on phase 17's config with nested
   calibration off (the sweep hands the engine explicit fold masks, which
   nested calibration refuses), seeds 42 and 43 (a cut of the sweep tier's
   42-44, ``MIL_SWEEP_SEEDS``): K1 launched (its count zeroed before and
   read after), the plain pool never; seed 42's fused predictions against
   its standalone run, printed (ragged group folds pad to the sweep's
   widest);
32. ``python -m pd_fusion_torch.scripts.submit_sweep --local --fused
   --synthetic --k-fold 5 --base-config configs/quickstart.yaml`` through
   its ``main`` over the seven models x seeds 42-44, each family at its
   config's widths (``configs/model_fusion.yaml``, ``model_moe.yaml``,
   ``model_unimodal.yaml`` on the device GBDT): every run directory's
   artifacts; ``fusion_moddrop`` and ``unimodal_clinical`` held against a
   standalone CV under each seed (the largest difference printed); the
   fused stacked trainer step (S x K = 15) under ``torch.profiler`` beside
   its bound; those two models' sequential ``--local`` sweeps timed beside
   their fused ones in turns (fused, local, local, fused);
   ``aggregate_results``, ``bootstrap_ci`` (n=1000) and ``generate_summary``
   on the 21 run directories and their files; the bootstrap program (1,000
   resamples x 1,500 rows) card vs CPU on the same indices
   (``analysis/sweep_checks.py``), then timed with CUDA events beside its
   bound;
33. ``ppmi_stress_test`` at its defaults (5 folds, 30 epochs, batch 128,
   moddrop 0.3) on phase 30's ``ppmi_subject_baseline.csv``: its files, 30
   finite rows; fold 1's MLP training card vs CPU on the same draws; one
   training step timed beside its bound;
34. ``ppmi_imaging_upgrade`` on phase 30's tables:
   ``configs/ppmi_imaging_upgrade.yaml`` uncut (3 seeds x 5 folds x 4
   settings x logreg/lgbm, SHAP on), the ``_progression`` and
   ``_imaging_available`` configs at one seed each (a cut), and, if the
   logistic fit won all three, the uncut config's settings with ``models:
   [lgbm]`` at one seed so the TreeSHAP leg runs: every artifact, finite
   metrics, each stage's wall and the SHAP leg's rows, chunks and seconds;
   then a GBDT round of the uncut config's stacked fit at its widest
   setting and a TreeSHAP chunk of the suites' 300 trees, profiled beside
   their bounds. K1 must launch 0 times in phases 32-35;
35. ``submit_sweep --dry-run`` and ``submit_dual_h200 --dry-run`` through
   their ``main`` with ``subprocess.run`` refusing: 21 scripts asking for
   one card each, and 2 jobs holding the 21 runs; nothing submitted;
36. the backend rule on the one card: ``torchrun --nproc-per-node 2 -m
   pd_fusion_torch.parallel.distributed`` with no backend named must fail
   on both ranks before NCCL starts, its error naming
   ``PD_FUSION_TORCH_DIST_BACKEND=gloo`` (NCCL itself refuses two ranks on
   one device: "Duplicate GPU detected");
37. the multi-device tier (``parallel/distributed.py``) in ``torchrun``
   children with a process-group timeout, each killed after
   ``DIST_CHILD_TIMEOUT_S``: (a) NCCL at world 1, ``all_reduce``,
   ``all_gather`` and ``broadcast`` on CUDA tensors held to known answers,
   the NCCL version printed; then one child of 2 ranks over gloo, both on
   ``cuda:0`` (``chip_smoke.py --dist-child``), for (b) and (c): (b)
   ``pd_fusion_torch.parallel.dryrun --size full``, the CV-engine legs on
   the (2x1) and (1x2) meshes, the MIL-FT step at the fine-tune config's
   width (ResNet-50, 224^2, 4 bags of 64 slices split 2+2, one unfrozen
   step: its params, and its all-reduced gradients in float64) with K1
   counted on each rank and each rank's peak memory, CNN3D at the data
   config's width; each leg against its world-1 run; then the MIL bag
   builder at world 2 over phase 14's 96 volumes against phase 16's bags,
   per subject within 5e-5; (c) the bench CV frame (``--k-fold 5 --model fusion_moddrop``)
   through the CLI at world 2 (a (1x2) mesh) against phase 7's in-process
   run, within 5e-3 on probabilities and 5e-2 on metrics, the CV engine's
   wall in the child beside phase 7's. The walls of (b) and (c) are
   printed as "2 ranks sharing one card over gloo" beside the card's name
   and power limit: findings, not claims;
39. (after 37, before 38's lines) the same result on every run: every
   device program of the paths above (``utils/determinism_checks.py``:
   the metrics and ECE at the bootstrap's and the bench frame's shapes,
   the tabular and fused-sweep trainers, device isotonic, the MoE trainer,
   the GBDT's two lowerings and ``predict_margin``, the MIL trainer with K1,
   a ResNet-50 flush, the fine-tune step frozen and not, the CNN3D step,
   the simple statistics, the logistic fit, the early-stopped MLP, a stress
   fold, a TreeSHAP chunk), each at its phase's width, twice from the same
   inputs and state, then once under
   ``torch.use_deterministic_algorithms(True, warn_only=True)`` for the
   ops PyTorch flags: one line a program (equal twice, the largest gap,
   the flagged ops, its source ``file:line``), K1 counted; then one fresh
   child (``chip_smoke.py --determinism-child``) runs the bench CV frame
   and the MIL CV on phase 16's bags through the CLI, the MIL bag build and
   the CNN3D build again, each held bit for bit against phases 7, 17, 16
   and 25 (results, fold probabilities, ``.npz`` bags, ``.parquet``
   embeddings), K1 counted in the MIL CV. A program listed as deterministic
   that differs between its two runs fails the smoke; the two by design
   (``hist_mode: scatter``, the unfrozen fine-tune step through cuDNN's
   backward kernels) are printed with their gaps. Then (c) what the
   repairs replaced: the earlier ECE (``scatter_add``) 20 times on one
   input and the CNN3D step through cuDNN's backward-data kernel twice,
   the unfrozen fine-tune step under cuDNN's deterministic algorithms
   twice, and each against the current form in turns (ECE and the six
   metrics at the bootstrap's shape, the CNN3D step, the fine-tune step);
38. a JSON line with each device program's host and device time and
   launches a step; one with each path's wall time, busy share and AUC
   (phase 39's records among them); one with each kernel's launches (by
   path), error and times (B=16 and B=80, and the launch floor); the card
   line again; then ``{"ok": true, "device": {...}}`` as the last line.

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
import statistics
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


@contextlib.contextmanager
def k1_backward_range(torch, ap):
    """K1's torch-op backward inside a ``record_function`` range."""
    backward = ap.AttentionPool.backward

    def ranged_backward(ctx, *grads):
        with torch.profiler.record_function(K1_BWD_RANGE):
            return backward(ctx, *grads)

    ap.AttentionPool.backward = staticmethod(ranged_backward)
    try:
        yield
    finally:
        ap.AttentionPool.backward = staticmethod(backward)


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

    run(1)
    torch.cuda.synchronize()
    with k1_backward_range(torch, ap):
        wall_ms, prof = profiled(torch, lambda: run(epochs))
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

    from pd_fusion_torch.utils.profiling import get_phase_times

    ap.reset_launch_counts()
    tt.minibatch_moddrop_impl = timed
    cv_before = get_phase_times().get("parallel_cv", 0.0)
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
            "trainer_s": trainer_s, "steps": steps, "call": (a, kw),
            "parallel_cv_s": get_phase_times()["parallel_cv"] - cv_before}


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
    events = f", {rec['event_ms'] * 1e3:.1f} us between CUDA events" if "event_ms" in rec else ""
    print(f"  program {name}: {rec['steps']} step(s), host {rec['host_us_per_step']:.1f} us a step "
          f"(unprofiled), device {rec['device_us_per_step']:.1f} us a step{events}, "
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
    3-axis TTA bags. -> (paths, programs, K1 launches of the MIL CV, the
    volumes' manifest)."""
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
    return paths, programs, k1["kernel"], manifest


# ---------------------------------------------------------------------------
# the MIL fine-tune (phases 20-22)
# ---------------------------------------------------------------------------

FT_CONFIG = ROOT / "configs" / "openneuro_ds001907_resnet2d_mil_ft.yaml"
# the CV's depth cuts; every width stays the config's. 24 subjects, not
# fewer: the nested calibration split (calibration_split 0.1, a 10-way
# group K-fold of a fold's training part) needs 10 rows of a class there
FT_SUBJECTS = 24
FT_DEPTH = {"epochs": 3, "freeze_backbone_epochs": 1}
FT_FOLDS = 2
FT_PREDICT_BAGS = 8  # bags predicted again after the artifact's reload


def ft_flops(ec, TR, backbone, arch, size, n_img, train_backbone):
    """Convolution FLOPs of one step: the forward; unfrozen also the blocks'
    recompute (remat) and the backward (weight and data gradients; the stem
    needs no data gradient): 4 F - 2 F_stem an image."""
    f = ec.resnet_flops(TR.fold_bn_inference(backbone, arch), arch, size)
    out = (size + 2 * 3 - 7) // 2 + 1
    f_stem = 2 * out * out * 64 * 3 * 7 * 7
    return n_img * (4 * f - 2 * f_stem if train_backbone else f), f


def ft_step_program(torch, ap, ft, fc, ec, TR, gate, B, L, hw):
    """The fine-tune step at full width on the card (``ft_step``, B bags of L
    slices, the config's widths): host, device, launches and busy share a
    step (``program_profile``: one warm-up step, one timed, two profiled),
    the step's wall and the time to enqueue it, peak device memory, TFLOP/s
    against the float32 bound, the top device ops, and K1's forward and
    backward (its kernel by symbol, its backward's torch ops by range). ->
    record."""
    backbone, head = fc.start_params()
    bp, hp = TR.params_to(backbone, device=DEV), TR.params_to(head, device=DEV)
    st = {"bp": bp, "hp": hp, "opt": {"backbone": ft.ft_optim.init_group(ft.trainable_leaves(bp)),
                                      "head": ft.ft_optim.init_group(ft.trainable_leaves(hp))}}
    batch = {k: torch.as_tensor(v, device=DEV)
             for k, v in fc.step_inputs(B, L, hw, seed=3, ragged=False).items()}
    hyper = fc.hyper(DEV)

    def step():
        st["bp"], st["hp"], _ = ft.ft_step(st["bp"], st["hp"], st["opt"], batch, gate, hyper)

    with k1_backward_range(torch, ap):
        rec = program_profile(torch, step, calls=2)
    prof = rec.pop("prof")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["peak_above_state_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    rec["enqueue_us"] = enqueue * 1e6
    rec["wall_us"] = wall * 1e6
    n_img = B * L
    flops, f_img = ft_flops(ec, TR, backbone, fc.ARCH, fc.SIZE, n_img, bool(gate))
    rec["tflop"] = flops / 1e12
    rec["tflops"] = flops / (rec["device_us_per_step"] / 1e6) / 1e12
    rec["bound_us"] = flops / H100_F32_FLOPS * 1e6
    rec["bound_by"] = "operations"
    rows = device_rows(torch, prof.key_averages())
    rows.sort(key=_dev_ms, reverse=True)
    rec["top"] = [(e.key[:60], _dev_ms(e) / 2, e.count / 2) for e in rows[:6]]
    dev_ms = rec["device_us_per_step"] / 1e3
    # K1's kernel is launched through ctypes, outside any torch op, so it is
    # found by its symbol; its backward is torch ops inside their range
    k1 = [e for e in rows if K1_SYMBOL in e.key]
    _, bwd_ms, bwd_n = range_device(torch, prof, K1_BWD_RANGE)
    for key, ms, launches in (("k1_fwd", sum(_dev_ms(e) for e in k1), sum(e.count for e in k1)),
                              ("k1_bwd", bwd_ms, bwd_n)):
        rec[f"{key}_us"] = ms / 2 * 1e3
        rec[f"{key}_launches"] = launches / 2
        rec[f"{key}_share"] = ms / 2 / dev_ms
    if rec["k1_fwd_launches"] < 1 or (gate and rec["k1_bwd_launches"] < 1):
        raise RuntimeError(f"the fine-tune step shows no K1 forward or backward kernel: {rec}")
    rec["gflop_per_image_fwd"] = f_img / 1e9
    return rec


def run_ft_path(torch, np, yaml, ap, cli, tmp: Path, manifest: Path):
    """Phases 20-22: one step card vs CPU; the full-width step profiled,
    frozen and not; the CLI CV at full width and reduced depth, then the
    single split and the artifact's reload. -> (paths, programs, K1
    launches of the CV)."""
    import pandas as pd

    from pd_fusion_torch.experiments import run_experiment
    from pd_fusion_torch.imaging import embed_checks as ec
    from pd_fusion_torch.models import ft_checks as fc
    from pd_fusion_torch.models import mil_attention_finetune as ft
    from pd_fusion_torch.models.serialization import load_model
    from pd_fusion_torch.nn import resnet as TR

    cfg = yaml.safe_load(FT_CONFIG.read_text())
    prm = dict(cfg["params"])
    programs, paths = {}, []

    # phase 20: one step, card against CPU
    t0 = time.perf_counter()
    errs = fc.compare_card_with_cpu(DEV)
    print(f"fine-tune step card vs CPU ({fc.ARCH}, {fc.SIZE}^2, B=2, L=8, gated head "
          f"{fc.HIDDEN}/{fc.ATTN}, focal, a ragged row, dropout keeps given; "
          f"models/ft_checks.py tolerances): {json.dumps(errs)}; "
          f"{time.perf_counter() - t0:.3f} s")

    # phase 21: the full-width step, frozen and unfrozen, under the profiler
    B, L = int(prm["batch_size"]), int(prm["slice_count"])
    hw = int(prm["target_shape"][0])
    for name, gate in (("mil_ft_step_frozen", 0.0), ("mil_ft_step_unfrozen", 1.0)):
        rec = ft_step_program(torch, ap, ft, fc, ec, TR, gate, B, L, hw)
        print_program(f"{name} (B={B}, L={L}, {hw}^2 -> {fc.SIZE}^2, {fc.ARCH} train-mode BN, "
                      f"remat, gated head, focal, two-group Adam)", rec)
        print(f"    step wall {rec['wall_us']:.1f} us (enqueue {rec['enqueue_us']:.1f} us); peak "
              f"{rec['peak_gib']:.3f} GiB ({rec['peak_above_state_gib']:.3f} above params, state "
              f"and batch); {rec['tflop']:.3f} TFLOP a step, {rec['tflops']:.2f} TFLOP/s over "
              f"the device time; bound {rec['bound_us']:.1f} us at 67 TFLOP/s float32 "
              f"({rec['bound_us'] / rec['device_us_per_step']:.4f} of it)")
        print(f"    K1 forward {rec['k1_fwd_us']:.3f} us ({rec['k1_fwd_launches']:.0f} launches, "
              f"share {rec['k1_fwd_share']:.6f}); K1 backward (torch ops) {rec['k1_bwd_us']:.3f} "
              f"us ({rec['k1_bwd_launches']:.0f} launches, share {rec['k1_bwd_share']:.6f})")
        for op, ms, count in rec["top"]:
            print(f"    {ms:10.3f} ms  x{count:<6.0f} {op}")
        programs[name] = rec

    # phase 22: the CLI CV at full width and reduced depth
    lines = manifest.read_text().splitlines()
    sub_manifest = tmp / "manifest_ft.csv"
    sub_manifest.write_text("\n".join(lines[:1 + 2 * FT_SUBJECTS]) + "\n")
    data_cfg = yaml.safe_load((ROOT / cfg["data_config"]).read_text())
    data_cfg["manifest_path"] = str(sub_manifest)
    (tmp / "data_ft.yaml").write_text(yaml.safe_dump(data_cfg))
    cfg["data_config"] = str(tmp / "data_ft.yaml")
    cfg["params"].update(FT_DEPTH)
    cfg["cv_folds"] = FT_FOLDS
    config = tmp / "ft.yaml"
    config.write_text(yaml.safe_dump(cfg))
    print(f"fine-tune CV cuts of depth (every width is the config's: {prm['backbone']}, "
          f"{prm['target_shape']}, {L} slices, {prm['input_size']}^2, batch {B}, gated, "
          f"{prm['loss_type']}, balanced, clip {prm['max_grad_norm']}, TTA {prm['tta_inference']}, "
          f"nested calibration): {FT_SUBJECTS} subjects x 2 sessions (not all of ds001907), "
          f"cv_folds {FT_FOLDS} (not {yaml.safe_load(FT_CONFIG.read_text())['cv_folds']}), epochs "
          f"{FT_DEPTH['epochs']} (not {prm['epochs']}), freeze_backbone_epochs "
          f"{FT_DEPTH['freeze_backbone_epochs']} (not {prm['freeze_backbone_epochs']}), so the gate "
          f"opens inside the run; random backbone (no download)")
    out = tmp / "ft_run"
    ft.SLICE_CACHE.clear()
    ap.reset_launch_counts()
    t0 = time.perf_counter()
    agg = cli.main(["run", "--config", str(config), "--output-dir", str(out)])
    cv_wall = time.perf_counter() - t0
    k1 = dict(ap.launch_counts)
    names = ["results_aggregated.yaml", "fold_assignments.csv", "summary_table.csv"]
    names += [f"results_fold_{i}.yaml" for i in range(1, FT_FOLDS + 1)]
    names += [f"preds_fold_{i}_full_observation.csv" for i in range(1, FT_FOLDS + 1)]
    require_files(out, names + plot_files(PLOTS, "_fold1"), "the fine-tune CV")
    on_disk = yaml.safe_load((out / "results_aggregated.yaml").read_text())
    if len(on_disk) != 7 or set(on_disk) != set(agg):
        raise RuntimeError("the fine-tune CV does not hold the 7 scenarios")
    if k1["kernel"] <= 0 or k1["plain"] != 0:
        raise RuntimeError(f"the fine-tune CV: K1 launches {k1}")
    auc = on_disk["full_observation"]["roc_auc"]["mean"]
    if not math.isfinite(auc):
        raise RuntimeError(f"the fine-tune CV: ROC-AUC {auc}")
    print(f"fine-tune CV ({FT_FOLDS}-fold, {2 * FT_SUBJECTS} volumes, python -m pd_fusion_torch.cli "
          f"run --config <copy of {FT_CONFIG.name}>): wall {cv_wall:.3f} s, K1 launches "
          f"{k1['kernel']}, plain 0, full_observation ROC-AUC {auc:.4f} +- "
          f"{on_disk['full_observation']['roc_auc']['std']:.4f} (no band: random backbone, "
          f"{FT_DEPTH['epochs']} epochs)")
    for scen, m in on_disk.items():
        print(f"  {scen}: roc_auc {m['roc_auc']['mean']:.4f} +- {m['roc_auc']['std']:.4f}")

    # the single split: results.yaml and the model artifact; the model as
    # trained, and reloaded, predict the same with tta_inference 1
    trained = []
    train_pipeline = run_experiment.train_pipeline

    def keep_model(*a, **kw):
        out = train_pipeline(*a, **kw)
        trained.append(out[0])
        return out

    single = {k: v for k, v in cfg.items() if k != "cv_folds"}
    single_config = tmp / "ft_single.yaml"
    single_config.write_text(yaml.safe_dump(single))
    run_out = tmp / "ft_single"
    ap.reset_launch_counts()
    t0 = time.perf_counter()
    run_experiment.train_pipeline = keep_model
    try:
        results = cli.main(["run", "--config", str(single_config), "--output-dir", str(run_out)])
    finally:
        run_experiment.train_pipeline = train_pipeline
    train_wall = time.perf_counter() - t0
    train_k1 = dict(ap.launch_counts)
    require_files(run_out, ["results.yaml", "model.pt", "preprocess.pkl"], "the fine-tune run")
    if len(results) != 7 or train_k1["plain"] != 0 or train_k1["kernel"] <= 0:
        raise RuntimeError(f"the fine-tune run: {len(results)} scenarios, K1 {train_k1}")
    model = trained[0]
    base = getattr(model, "base_model", model)
    base.save(tmp / "ft_artifact.pt")
    bags = pd.read_csv(sub_manifest)["t1wbrain_path"].tolist()[:FT_PREDICT_BAGS]
    want = {}
    for what, m in (("trained", base), ("model.pt", load_model(run_out / "model.pt")),
                    ("kind artifact", load_model(tmp / "ft_artifact.pt"))):
        m = getattr(m, "base_model", m)
        m.tta_inference = 1
        want[what] = m.predict_proba(bags)
    reload_err = max(float(np.abs(v - want["trained"]).max()) for v in want.values())
    if not (np.isfinite(want["trained"]).all() and reload_err <= 1e-6):
        raise RuntimeError(f"the reloaded fine-tune model predicts {want}")
    print(f"fine-tune single split (run --config <the copy without cv_folds>): wall "
          f"{train_wall:.3f} s, K1 launches {train_k1['kernel']}; model.pt "
          f"({type(model).__name__}) and the mil_attention_ft artifact reloaded with load_model "
          f"predict {FT_PREDICT_BAGS} bags as the trained model (tta_inference 1): max abs err "
          f"{reload_err:.3e}, uncalibrated probabilities {want['trained'].min():.6f} to "
          f"{want['trained'].max():.6f}; full_observation ROC-AUC "
          f"{results['full_observation']['roc_auc']:.4f}")

    # the predict chunk with TTA, as predict_proba runs it (slices cached)
    base.tta_inference = int(prm["tta_inference"])
    rec = program_profile(torch, lambda: base.predict_proba(bags[:B]), calls=2)
    rec.pop("prof")
    f_img = programs["mil_ft_step_frozen"]["gflop_per_image_fwd"] * 1e9
    flops = f_img * B * L * base.tta_inference
    rec["tflops"] = flops / (rec["device_us_per_step"] / 1e6) / 1e12
    rec["bound_us"], rec["bound_by"] = flops / H100_F32_FLOPS * 1e6, "operations"
    print_program(f"mil_ft_predict_chunk (B={B} bags, TTA {base.tta_inference}, host noise draws "
                  f"included)", rec)
    print(f"    {rec['tflops']:.2f} TFLOP/s; bound {rec['bound_us']:.1f} us")
    programs["mil_ft_predict_chunk_tta"] = rec
    paths.append({"name": "mil_ft_cv", "volumes": 2 * FT_SUBJECTS, "folds": FT_FOLDS,
                  "epochs": FT_DEPTH["epochs"], "wall_s": cv_wall, "auc": auc,
                  "k1_launches": k1["kernel"], "train_wall_s": train_wall,
                  "train_k1_launches": train_k1["kernel"], "reload_max_abs_err": reload_err,
                  "card_vs_cpu": errs})
    return paths, programs, k1["kernel"]


# ---------------------------------------------------------------------------
# the ds001907 volume-feature path and a dev dataset (phases 23-27)
# ---------------------------------------------------------------------------

SIMPLE_CONFIG = ROOT / "configs" / "openneuro_ds001907_simple.yaml"
VOLUME_CHECKS = 10  # volumes of phase 14 in the CNN3D step's card-vs-CPU check
EMBED_TIMED = 96  # volumes in the timed CNN3D embed forward


def volume_config_copy(yaml, tmp: Path, manifest: Path, cache: Path, mode: str):
    """A copy of configs/openneuro_ds001907_simple.yaml whose data config
    points at ``manifest`` and ``cache`` with ``feature_mode: mode``; every
    other setting stays the repo's. -> config path."""
    cfg = yaml.safe_load(SIMPLE_CONFIG.read_text())
    data_cfg = yaml.safe_load((ROOT / cfg["data_config"]).read_text())
    data_cfg.update(manifest_path=str(manifest), feature_mode=mode, feature_cache_dir=str(cache),
                    embedding_cache_dir=str(cache))
    (tmp / f"data_volume_{mode}.yaml").write_text(yaml.safe_dump(data_cfg))
    cfg["data_config"] = str(tmp / f"data_volume_{mode}.yaml")
    path = tmp / f"volume_{mode}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def run_cli_checked(yaml, ap, cli, argv, out: Path, k: int, what: str):
    """One CV run through the CLI: its artifacts, the eval config's
    scenarios, a finite full-observation ROC-AUC, K1 launched neither as
    kernel nor plain. -> (wall s, aggregated results, K1 launch counts)."""
    ap.reset_launch_counts()
    t0 = time.perf_counter()
    agg = cli.main(argv + ["--output-dir", str(out)])
    wall = time.perf_counter() - t0
    k1 = dict(ap.launch_counts)
    if k1 != {"kernel": 0, "plain": 0}:
        raise RuntimeError(f"{what} launched K1: {k1}")
    names = ["results_aggregated.yaml", "fold_assignments.csv", "summary_table.csv",
             "provenance.yaml"]
    names += [f"results_fold_{i}.yaml" for i in range(1, k + 1)]
    names += [f"preds_fold_{i}_full_observation.csv" for i in range(1, k + 1)]
    require_files(out, names, what)
    on_disk = yaml.safe_load((out / "results_aggregated.yaml").read_text())
    eval_cfg = yaml.safe_load((out / "eval_config.yaml").read_text())
    scens = [s["name"] for s in eval_cfg["scenarios"]]
    auc = on_disk["full_observation"]["roc_auc"]["mean"]
    if set(on_disk) != set(agg) or set(on_disk) != set(scens) or not math.isfinite(auc):
        raise RuntimeError(f"{what}: scenarios {sorted(on_disk)}, ROC-AUC {auc}")
    return wall, on_disk, k1


def top_ops(torch, prof, calls, n=6):
    """The ``n`` device rows of a ``program_profile`` with the most device
    time: (name, ms a call, launches a call)."""
    rows = sorted(device_rows(torch, prof.key_averages()), key=_dev_ms, reverse=True)
    return [(e.key[:80], _dev_ms(e) / calls, e.count / calls) for e in rows[:n]]


def with_event_time(torch, rec, fn, reps=5):
    """``rec`` with ``event_ms``: a call between two CUDA events on its
    stream, median of ``reps`` (a second device clock beside the profiler's
    kernel sum; for a device-bound program the two agree)."""
    rec["event_ms"] = _median_event_ms(torch, fn, reps)
    return rec


def print_top(rec):
    for op, ms, count in rec["top"]:
        print(f"    {ms:10.3f} ms  x{count:<6.1f} {op}")


@contextlib.contextmanager
def cudnn_weight_gradients(torch, cnn3d):
    """The CNN3D layers as the plain ops, so that autograd takes cuDNN's own
    weight gradients (the port writes them as batched matrix products):
    the other arm of a comparison in turns."""
    import torch.nn.functional as F

    class Conv:
        apply = staticmethod(lambda x, w, b: F.conv3d(x, w, b, padding=1))

    class Deconv:
        apply = staticmethod(lambda x, w, b: F.conv_transpose3d(x, w, b, stride=2))

    ours = cnn3d._Conv3x3, cnn3d._Deconv2
    cnn3d._Conv3x3, cnn3d._Deconv2 = Conv, Deconv
    try:
        yield
    finally:
        cnn3d._Conv3x3, cnn3d._Deconv2 = ours


def step_program(torch, cnn3d, cfg, lr):
    """One CNN3D train step at ``cfg``'s widths on the card, from a seeded
    init on z-scored synthetic volumes (``program_profile``), with its peak
    memory, TFLOP/s and bound; then the step's time (CUDA events, median of
    5 calls) in turns against the step through cuDNN's weight gradients
    (ours, cuDNN's, cuDNN's, ours)."""
    from pd_fusion_torch.nn import cnn3d_checks as cc

    shape, B, E = tuple(cfg["target_shape"]), int(cfg["batch_size"]), int(cfg["embedding_dim"])
    x = torch.from_numpy(cc.synthetic_volumes(B, shape, seed=5)).to(DEV)[:, None]
    w = torch.ones(B, device=DEV)
    st = {"p": cnn3d.params_to(cnn3d.cnn3d_init(torch.Generator().manual_seed(0), shape, E), DEV)}
    st["opt"] = cnn3d.init_opt(st["p"])

    def step():
        st["p"], _ = cnn3d.train_step(st["p"], st["opt"], x, w, lr, shape)

    turns = {"gemm_wgrad_ms": [], "cudnn_wgrad_ms": []}
    for arm in ("gemm_wgrad_ms", "cudnn_wgrad_ms", "cudnn_wgrad_ms", "gemm_wgrad_ms"):
        with (cudnn_weight_gradients(torch, cnn3d) if arm == "cudnn_wgrad_ms"
              else contextlib.nullcontext()):
            step()
            turns[arm].append(_median_event_ms(torch, step, 5))
    with cudnn_weight_gradients(torch, cnn3d):
        _, prof = profiled(torch, step)
    rec = with_event_time(torch, program_profile(torch, step, calls=2), step)
    rec["turns"] = turns
    rec["cudnn_top"] = top_ops(torch, prof, 1, n=3)
    rec["top"] = top_ops(torch, rec.pop("prof"), 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    flops = cc.train_step_flops(shape, E, B)
    rec["gflop"] = flops / 1e9
    rec["tflops"] = flops / (rec["device_us_per_step"] / 1e6) / 1e12
    rec["bound_us"], rec["bound_by"] = flops / H100_F32_FLOPS * 1e6, "operations"
    return rec


def simple_data_config(yaml) -> dict:
    """The data config of ``configs/openneuro_ds001907_simple.yaml``."""
    return yaml.safe_load((ROOT / yaml.safe_load(SIMPLE_CONFIG.read_text())["data_config"])
                          .read_text())


def cnn3d_argv(cnn_cfg, manifest: Path, out_dir: Path):
    """The CNN3D builder script's flags for a data config's ``cnn_config``."""
    return ["--manifest", str(manifest), "--out-dir", str(out_dir),
            "--target-shape", *map(str, cnn_cfg["target_shape"]),
            "--embedding-dim", str(cnn_cfg["embedding_dim"]), "--epochs", str(cnn_cfg["epochs"]),
            "--batch-size", str(cnn_cfg["batch_size"]), "--lr", str(cnn_cfg["lr"])]


def run_volume_path(torch, np, yaml, ap, cli, tmp: Path, manifest: Path):
    """Phases 23-27: the simple statistics card vs CPU and timed; one CNN3D
    step card vs CPU, timed at the data config's and the runbook's widths,
    and the embed forward; the CNN3D builder script on the 96 volumes and
    the CLI's CV on its embeddings; the CV with the simple features built on
    first load; ``--dataset uci_parkinsons`` on a seeded fixture. ->
    (paths, programs, K1 launches by path)."""
    import os

    import pandas as pd

    from pd_fusion_torch.data import openneuro_features
    from pd_fusion_torch.data.dev_datasets.uci_parkinsons import synthetic_frame
    from pd_fusion_torch.imaging.pipeline import VolumePrefetcher, load_volume, make_volume_loader
    from pd_fusion_torch.nn import cnn3d
    from pd_fusion_torch.nn import cnn3d_checks as cc
    from pd_fusion_torch.ops import volume_stats_checks as vsc
    from pd_fusion_torch.ops.image import zscore_volume
    from pd_fusion_torch.ops.volume_stats import n_features, simple_volume_features
    from pd_fusion_torch.paths import DEV_DATA_ENV
    from pd_fusion_torch.scripts import build_cnn3d_embeddings as script

    data_cfg = simple_data_config(yaml)
    feat_cfg, cnn_cfg = data_cfg["feature_config"], data_cfg["cnn_config"]
    if {**cnn_cfg, "target_shape": tuple(cnn_cfg["target_shape"])} != {
            **cc.CNN_CONFIG, "epochs": cnn_cfg["epochs"]}:
        raise RuntimeError(f"cnn3d_checks.CNN_CONFIG is not the data config's {cnn_cfg}")
    paths_df = pd.read_csv(manifest)
    vol_paths = paths_df["t1wbrain_path"].tolist()
    programs, paths, launches = {}, [], {}
    t_phases = time.perf_counter()

    # phase 23: the simple statistics of one batch, card against CPU, then timed
    bins, grid = int(feat_cfg["hist_bins"]), int(feat_cfg["grid_size"])
    target = tuple(feat_cfg["target_shape"])
    B = openneuro_features.STATS_BATCH
    vols = np.stack([v for _, v in VolumePrefetcher(vol_paths[:B], make_volume_loader(target),
                                                    depth=8)])
    t0 = time.perf_counter()
    errs = vsc.compare_card_with_cpu(vols, DEV, bins, grid)
    print(f"simple_volume_features card vs CPU ({B} of phase 14's volumes at {target}, {bins} bins, "
          f"grid {grid}; order statistics and histogram equal, the rest within "
          f"ops/volume_stats_checks.py's bounds): {json.dumps(errs)}; {time.perf_counter() - t0:.3f} s")
    on_card = torch.from_numpy(vols).to(DEV)
    for extra in (False, True):
        stats = lambda: simple_volume_features(on_card, bins, grid, extra)  # noqa: E731
        rec = with_event_time(torch, program_profile(torch, stats, calls=2), stats)
        rec["top"] = top_ops(torch, rec.pop("prof"), 2)
        n_bytes = vols.nbytes + B * n_features(bins, grid, extra) * 4
        rec["bytes"] = n_bytes
        rec["bound_us"], rec["bound_by"] = n_bytes / H100_BYTES_PER_S * 1e6, "bytes"
        name = f"volume_stats_batch{B}_{'extra' if extra else 'plain'}"
        print_program(f"{name} ({B} x {target}, {bins} bins, grid {grid})", rec)
        print(f"    bound {rec['bound_us']:.3f} us by bytes ({n_bytes} B at 3.35 TB/s): "
              f"{rec['bound_us'] / rec['device_us_per_step']:.4f} of the device time")
        print_top(rec)
        programs[name] = rec
    del on_card

    # phase 24: one CNN3D step card vs CPU, then the step timed at both widths
    # and the embed forward
    shape = tuple(cnn_cfg["target_shape"])
    t0 = time.perf_counter()
    check_vols = np.stack([zscore_volume(torch.from_numpy(load_volume(p, shape))).numpy()
                           for p in vol_paths[:VOLUME_CHECKS]])
    step_errs = cc.compare_card_with_cpu(check_vols, DEV, cc.CNN_CONFIG)
    print(f"CNN3D step card vs CPU ({cc.CNN_CONFIG}; nn/cnn3d_checks.py tolerances): "
          f"{json.dumps(step_errs)}; {time.perf_counter() - t0:.3f} s")
    lr = float(cnn_cfg["lr"])
    for name, cfg in (("cnn3d_step_cnn_config", cc.CNN_CONFIG),
                      ("cnn3d_step_runbook", cc.RUNBOOK_CONFIG)):
        rec = step_program(torch, cnn3d, cfg, lr)
        print_program(f"{name} ({cfg})", rec)
        print(f"    {rec['gflop']:.3f} GFLOP a step, {rec['tflops']:.3f} TFLOP/s; bound "
              f"{rec['bound_us']:.1f} us at 67 TFLOP/s float32 "
              f"({rec['bound_us'] / rec['device_us_per_step']:.4f} of it); peak "
              f"{rec['peak_gib']:.3f} GiB; in turns (CUDA events, ours, cuDNN's, cuDNN's, ours): "
              f"weight gradients as matrix products {rec['turns']['gemm_wgrad_ms']} ms, "
              f"cuDNN's {rec['turns']['cudnn_wgrad_ms']} ms; the step through cuDNN's weight "
              f"gradients, its top kernels:")
        print_top({"top": rec["cudnn_top"]})
        print("    ours, its top kernels:")
        print_top(rec)
        programs[name] = rec
    E = int(cnn_cfg["embedding_dim"])
    params = cnn3d.params_to(cnn3d.cnn3d_init(torch.Generator().manual_seed(0), shape, E), DEV)
    x96 = torch.from_numpy(cc.synthetic_volumes(EMBED_TIMED, shape, seed=6)).to(DEV)[:, None]
    embed = lambda: cnn3d.cnn3d_embed(params, x96, shape)  # noqa: E731
    rec = with_event_time(torch, program_profile(torch, embed, calls=2), embed)
    rec["top"] = top_ops(torch, rec.pop("prof"), 2)
    flops = EMBED_TIMED * sum(cc.forward_flops(shape, E).values())
    n_bytes = x96.numel() * 4 + EMBED_TIMED * E * 4 + sum(t.numel() * 4 for t in cnn3d.leaves(params))
    rec["tflops"] = flops / (rec["device_us_per_step"] / 1e6) / 1e12
    rec["bound_us"], rec["bound_by"] = embed_bound(flops, n_bytes, H100_F32_FLOPS)
    print_program(f"cnn3d_embed ({EMBED_TIMED} x {shape}, embedding {E})", rec)
    print(f"    {flops / 1e9:.3f} GFLOP, {rec['tflops']:.3f} TFLOP/s; bound {rec['bound_us']:.1f} "
          f"us ({rec['bound_by']})")
    print_top(rec)
    programs[f"cnn3d_embed_{EMBED_TIMED}"] = rec
    del x96, params

    # phase 25: the CNN3D builder script on the 96 volumes with the data
    # config's cnn_config, then the CLI's CV on its embeddings
    cache = tmp / "cnn3d_cache"
    argv = cnn3d_argv(cnn_cfg, manifest, cache)
    if script.config_from_args(script.parse_args(argv)) != cnn_cfg:
        raise RuntimeError(f"the script's flags do not give the data config's {cnn_cfg}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    built = script.main(argv)
    build_wall = time.perf_counter() - t0
    emb = pd.read_parquet(built["path"]).filter(like="mri_cnn_").to_numpy()
    if emb.shape != (len(vol_paths), E) or not np.isfinite(emb).all():
        raise RuntimeError(f"the CNN3D embeddings: shape {emb.shape}, finite "
                           f"{np.isfinite(emb).all()}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"CNN3D build (python -m pd_fusion_torch.scripts.build_cnn3d_embeddings, "
          f"{len(vol_paths)} volumes, {cnn_cfg}): wall {build_wall:.3f} s, stages "
          f"{json.dumps({k: round(v, 3) for k, v in built['stages'].items()})}, peak {peak:.3f} GiB")
    config = volume_config_copy(yaml, tmp, manifest, cache, "cnn3d")
    k = int(yaml.safe_load(config.read_text())["cv_folds"])
    wall, agg, launches["cnn3d_cv"] = run_cli_checked(
        yaml, ap, cli, ["run", "--config", str(config)], tmp / "cnn3d_run", k, "the cnn3d CV")
    require_files(tmp / "cnn3d_run", plot_files(PLOTS, "_fold1"), "the cnn3d CV")
    auc = agg["full_observation"]["roc_auc"]
    print(f"cnn3d CV (copy of {SIMPLE_CONFIG.name}, feature_mode cnn3d: fusion_moddrop, "
          f"calibrated, nested, {k}-fold): wall {wall:.3f} s, full_observation ROC-AUC "
          f"{auc['mean']:.4f} +- {auc['std']:.4f}, K1 launches 0, plain 0")
    paths.append({"name": "cnn3d_build", "volumes": len(vol_paths), "wall_s": build_wall,
                  "peak_gib": peak, **built["stages"]})
    paths.append({"name": "cnn3d_cv", "wall_s": wall, "auc": auc["mean"]})

    # phase 26: the same CV with feature_mode simple: the features build on
    # first load
    config = volume_config_copy(yaml, tmp, manifest, tmp / "simple_cache", "simple")
    stages = {}
    with timed(torch, openneuro_features, "load_simple_features", stages, "build_s"):
        wall, agg, launches["simple_cv"] = run_cli_checked(
            yaml, ap, cli, ["run", "--config", str(config)], tmp / "simple_run", k,
            "the simple CV")
    feats = pd.read_parquet(next((tmp / "simple_cache").glob("features_*.parquet")))
    cols = [c for c in feats if c.startswith("mri_feat_")]
    if len(feats) != len(vol_paths) or len(cols) != n_features(bins, grid) or not np.isfinite(
            feats[cols].to_numpy()).all():
        raise RuntimeError(f"the simple features: {feats.shape}")
    auc = agg["full_observation"]["roc_auc"]
    print(f"simple CV (feature_mode simple, {feat_cfg}): wall {wall:.3f} s = feature build "
          f"{stages['build_s']:.3f} s ({len(vol_paths) / stages['build_s']:.2f} volumes/s) + CV "
          f"{wall - stages['build_s']:.3f} s; full_observation ROC-AUC {auc['mean']:.4f} +- "
          f"{auc['std']:.4f}, K1 launches 0, plain 0")
    paths.append({"name": "simple_cv", "wall_s": wall, "feature_build_s": stages["build_s"],
                  "cv_s": wall - stages["build_s"], "auc": auc["mean"]})

    # phase 27: a dev dataset through the CLI, on a seeded fixture file
    dev = tmp / "dev_data"
    (dev / "uci").mkdir(parents=True)
    synthetic_frame().to_csv(dev / "uci" / "parkinsons.data", index=False)
    before = os.environ.get(DEV_DATA_ENV)
    os.environ[DEV_DATA_ENV] = str(dev)
    try:
        wall, agg, launches["uci_parkinsons_cv"] = run_cli_checked(
            yaml, ap, cli, ["run", "--config", str(QUICKSTART), "--dataset", "uci_parkinsons",
                            "--k-fold", "5"], tmp / "uci_run", 5, "the uci_parkinsons CV")
    finally:
        if before is None:
            os.environ.pop(DEV_DATA_ENV)
        else:
            os.environ[DEV_DATA_ENV] = before
    auc = agg["full_observation"]["roc_auc"]
    print(f"uci_parkinsons CV (run --config {QUICKSTART.name} --dataset uci_parkinsons --k-fold 5 "
          f"on a seeded 195-row fixture with UCI's columns): wall {wall:.3f} s, full_observation "
          f"ROC-AUC {auc['mean']:.4f} +- {auc['std']:.4f}, K1 launches 0, plain 0")
    paths.append({"name": "uci_parkinsons_cv", "wall_s": wall, "auc": auc["mean"]})
    print(f"phases 23-27: {time.perf_counter() - t_phases:.3f} s")
    programs[f"volume_stats_batch{B}_plain"]["card_vs_cpu"] = errs
    programs["cnn3d_step_cnn_config"]["card_vs_cpu"] = step_errs
    return paths, programs, launches


# ---------------------------------------------------------------------------
# download-dev and the PPMI study-data path (phases 28-30)
# ---------------------------------------------------------------------------

STUDY_CONFIG = ROOT / "configs" / "ppmi_studydata.yaml"
STUDY_SUBJECTS = 1500  # PD and HC subjects of the synthetic study data (plus 200 excluded)
# the sweep's seeds: the config's five, unless a cut is recorded here (depth
# only: every ablation, model and width stays the config's)
STUDY_SEEDS = None


def run_download_dev(ap, cli, tmp: Path):
    """Phase 28: ``download-dev`` through the port's CLI, in this process
    with a PATH that holds no ``openneuro`` CLI and ``urlopen`` refusing,
    on a base directory where the UCI files exist: it must return, fetch
    and change nothing and print the manual instructions. K1's counts are
    zeroed just before and read just after. -> (path record, K1 counts)."""
    import contextlib
    import io
    import os
    import urllib.request
    from unittest import mock

    from pd_fusion_torch.data.download.uci_download import UCI_SOURCES

    base, empty = tmp / "raw_dev", tmp / "empty_bin"
    (base / "uci").mkdir(parents=True)
    empty.mkdir()
    for name in UCI_SOURCES:
        (base / "uci" / name).write_text("cached")

    def refuse(url, *a, **kw):
        raise RuntimeError(f"download-dev tried to fetch {url}")

    out = io.StringIO()
    ap.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, PATH=str(empty)), \
            mock.patch.object(urllib.request, "urlopen", refuse), contextlib.redirect_stdout(out):
        cli.main(["download-dev", "--out", str(base)])
    wall = time.perf_counter() - t0
    launches = dict(ap.launch_counts)
    printed = out.getvalue()
    if launches != {"kernel": 0, "plain": 0}:
        raise RuntimeError(f"download-dev launched K1: {launches}")
    if "MANUAL DOWNLOAD REQUIRED" not in printed or "BioFIND" not in printed:
        raise RuntimeError(f"download-dev printed no manual instructions:\n{printed}")
    changed = [n for n in UCI_SOURCES if (base / "uci" / n).read_text() != "cached"]
    if changed or (base / "openneuro").exists():
        raise RuntimeError(f"download-dev fetched something: {changed or 'openneuro/'}")
    print(f"download-dev (pd_fusion_torch.cli.main(['download-dev', '--out', <base>]), UCI "
          f"files present, no openneuro CLI on PATH): returned in {wall:.3f} s, nothing "
          f"fetched, manual instructions printed ({len(printed.splitlines())} lines), K1 "
          f"{launches}")
    return {"name": "download_dev", "wall_s": wall}, launches


def run_tabular_checks(torch) -> dict:
    """Phase 29: the suites' device programs on the card against the CPU
    (``analysis/tabular_checks.py``, shared with the ``cuda`` tests)."""
    from pd_fusion_torch.analysis import tabular_checks as tc

    errs = {"logreg_coef_rel": tc.check_logreg("cuda"),
            "auc_screen_abs": tc.check_auc_screen("cuda"),
            "permutation_auc_abs": tc.check_permutation_screen("cuda"),
            "tabular_prep_abs": tc.check_tabular_prep()}
    print(f"balanced logistic fit {tc.LOGREG_SHAPE} card vs CPU: coefficients "
          f"{errs['logreg_coef_rel']:.3e} of the largest (tolerance {tc.LOGREG_RTOL})")
    print(f"AUC screen {tc.AUC_SHAPE} card vs CPU: max abs err {errs['auc_screen_abs']:.3e} "
          f"(tolerance {tc.AUC_ATOL})")
    print(f"permutation screen {tc.PERM_SHAPE}, 5 repeats x 80 epochs, card vs CPU: AUCs "
          f"{errs['permutation_auc_abs']:.3e} apart (tolerance {tc.PERM_AUC_ATOL})")
    print(f"TabularPrep vs the sweep transformer's numeric block: {errs['tabular_prep_abs']:.3e} "
          f"(tolerance {tc.PREP_ATOL})")
    t0 = time.perf_counter()
    stack = tc.check_gbdt_stack("cuda", **tc.GBDT_STACK)
    print(f"GBDT fold-batched fit vs each model's own fit on the card ({tc.GBDT_STACK}, the "
          f"suites' settings): bitwise {stack['bitwise']}, first forked round "
          f"{stack['first_fork']} ({time.perf_counter() - t0:.2f} s)")
    return {**errs, "gbdt_stack_bitwise": stack["bitwise"],
            "gbdt_stack_first_fork": stack["first_fork"]}


def _finite(frame, what):
    """Every numeric cell of ``frame`` is finite, and it has rows."""
    num = frame.select_dtypes("number")
    bad = [c for c in num.columns if not num[c].map(math.isfinite).all()]
    if frame.empty or bad:
        raise RuntimeError(f"{what}: {'no rows' if frame.empty else f'non-finite {bad}'}")


def stacked_gbdt_round(torch, np, Xs, ys, rounds):
    """``train_gbdt``'s inputs for the suites' GBDTs on ``(Xs[i], ys[i])``
    stacked as ``fit_gbdt_stack`` stacks them, ``rounds`` of the suites'
    300, and the bound of those rounds. -> (args, hparams, (bound ms,
    bound by), (K, rows, features))."""
    from pd_fusion_torch.analysis.tabular import SUITE_GBDT
    from pd_fusion_torch.nn.gbdt import MISSING_BIN, N_VALUE_BINS, DeviceHistGBDT

    proto = DeviceHistGBDT(**SUITE_GBDT)
    prepared = [proto._fit_inputs(X, y) for X, y in zip(Xs, ys)]
    K, n_max = len(prepared), max(len(p[2]) for p in prepared)
    f_max = max(p[1].shape[1] for p in prepared)
    bins = np.full((K, n_max, f_max), MISSING_BIN, np.int32)
    yk, wk = np.zeros((K, n_max), np.float32), np.zeros((K, n_max), np.float32)
    for k, (_, b, yy, ww, _) in enumerate(prepared):
        bins[k, : b.shape[0], : b.shape[1]], yk[k, : len(yy)], wk[k, : len(yy)] = b, yy, ww
    t = lambda a: torch.as_tensor(a, device=DEV)  # noqa: E731
    args = (t(bins), t(yk), t(wk), t(np.array([p[4] for p in prepared], np.float32)))
    hp = dict(proto.hparams(), n_rounds=rounds)
    # what a round needs, level by level: the bins and the (g, h, w) rows
    # read once, three adds per row and feature into the histograms, and
    # the split scan (cumsum and two gain arms, about 33 operations per
    # node, feature and threshold); the onehot lowering's own products are
    # reported apart, as its throughput
    depth, per_bin = hp["depth"], 3 + 2 * 15
    n_bytes = depth * (bins.size * bins.itemsize + 3 * K * n_max * 4)
    ops = sum(3 * K * n_max * f_max + per_bin * K * (1 << lv) * f_max * N_VALUE_BINS
              for lv in range(depth))
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_FLOPS * 1e3
    bound = (max(t_bytes, t_ops) * rounds, "bytes" if t_bytes >= t_ops else "operations")
    return args, hp, bound, (K, n_max, f_max)


def study_programs(torch, np, cfg, processed: Path, seeds) -> dict:
    """The suites' device programs at the sweep's widest ablation
    (full_fusion) on seed ``seeds[0]``'s split, each as the suite calls it:
    host time unprofiled, device time and launches under the profiler,
    and the median between two CUDA events."""
    import pandas as pd

    from pd_fusion_torch.analysis.column_transformer import SuiteColumnTransformer
    from pd_fusion_torch.analysis.tabular import numeric_feature_columns, permutation_inputs
    from pd_fusion_torch.nn.gbdt import train_gbdt
    from pd_fusion_torch.nn.logreg import BalancedLogisticRegression
    from pd_fusion_torch.nn.trainer import fullbatch_impl
    from pd_fusion_torch.ops.metrics import roc_auc
    from pd_fusion_torch.scripts import ppmi_meaningful_suite as ms
    from pd_fusion_torch.scripts import ppmi_train_tabular as tt

    df = pd.read_csv(processed / "ppmi_subject_baseline.csv", low_memory=False)
    df["subject_id"] = df["subject_id"].astype(str)
    schema = json.loads((processed / "ppmi_feature_schema.json").read_text())
    groups = next(a for a in cfg["ablations"] if a["name"] == "full_fusion")["groups"]
    cols = [c for g in groups for c in schema["groups"][g]["features"]]
    num = [c for c in cols if pd.api.types.is_numeric_dtype(df[c])]
    parts = []
    for seed in seeds:
        ids = json.loads((processed / f"ppmi_splits_seed{seed}.json").read_text())
        tr, va, te = (df[df["subject_id"].isin(ids[k])] for k in ("train", "val", "test"))
        pre = SuiteColumnTransformer(True, num, [c for c in cols if c not in num])
        parts.append((pre.fit_transform(tr[cols]), tr["label"].to_numpy(),
                      pre.transform(va[cols]), va["label"].to_numpy()))
    X, y, Xv, yv = parts[0]
    n, d = X.shape
    programs = {}

    def record(name, fn, steps, bound_ms, bound_by, calls=1):
        rec = with_event_time(torch, program_profile(torch, fn, steps=steps, calls=calls), fn,
                              reps=3)
        rec.update(bound_ms_per_call=bound_ms, bound_by=bound_by)
        print_program(name, rec)
        print(f"    bound {bound_ms:.6f} ms a call by {bound_by}")
        programs[name] = rec

    # the univariate screen over every numeric column of the baseline table
    screen_cols = numeric_feature_columns(df, ms.GLOBAL_EXCLUDE_REGEX, ms.ID_COLS)
    mat = df[screen_cols].apply(pd.to_numeric, errors="coerce")
    mat = mat.fillna(mat.median()).to_numpy(np.float32)
    cols_dev = torch.as_tensor(np.ascontiguousarray(mat.T), device=DEV)
    lab_dev = torch.as_tensor(df["label"].to_numpy(np.float32), device=DEV)
    n_bytes = (mat.size + 2 * mat.shape[0] + mat.shape[1]) * 4
    record(f"auc_screen_F{mat.shape[1]}_N{mat.shape[0]}", lambda: roc_auc(lab_dev, cols_dev),
           1, n_bytes / H100_BYTES_PER_S * 1e3, "bytes")

    # the permutation probes: 5 repeats x 80 full-batch steps on the stacked axis
    Xtr, ytr, wtr, Xte, yte = (torch.as_tensor(a, device=DEV) for a in permutation_inputs(
        df, screen_cols, 5, 42))
    R, n_tr, dp = Xtr.shape

    def probes():
        probe = [{"w": torch.zeros((R, dp, 1), device=DEV), "b": torch.zeros((R, 1), device=DEV)}]
        fit = fullbatch_impl(probe, Xtr, ytr, wtr, None, 0.05, 80, 0.0, 0.0)
        return roc_auc(yte, torch.bmm(Xte, fit[0]["w"])[..., 0] + fit[0]["b"])

    flops = 80 * 6 * R * n_tr * dp + 2 * R * Xte.shape[1] * dp
    n_bytes = sum(t.numel() for t in (Xtr, ytr, wtr, Xte, yte)) * 4
    record(f"permutation_probes_R{R}_n{n_tr}_d{dp}", probes, 80,
           max(flops / H100_F32_FLOPS, n_bytes / H100_BYTES_PER_S) * 1e3,
           "operations" if flops / H100_F32_FLOPS > n_bytes / H100_BYTES_PER_S else "bytes")

    # the balanced logistic fit (float64 Newton); bound by its bytes (the
    # float64 peak is not in the measurement table)
    steps = BalancedLogisticRegression(max_iter=1000).fit(X, y).n_iter_[0]
    record(f"logreg_fit_n{n}_d{d}", lambda: BalancedLogisticRegression(max_iter=1000).fit(X, y),
           int(steps), (n * (d + 3)) * 8 / H100_BYTES_PER_S * 1e3, "bytes")

    # the early-stopped MLP of the sweep's config
    mcfg = cfg["mlp"]
    h = [d, *mcfg["hidden_dims"], 1]
    per_epoch = sum(6 * n * a * b + 2 * len(yv) * a * b for a, b in zip(h[:-1], h[1:]))
    record(f"mlp_earlystop_n{n}_d{d}", lambda: tt.train_mlp(X, y, Xv, yv, 42, mcfg)(Xv), 1,
           per_epoch * int(mcfg["max_epochs"]) / H100_F32_FLOPS * 1e3, "operations (all epochs)")

    # the GBDT arm's device program: the seeds' ensembles as one
    # fold-batched train_gbdt call (binned as fit_gbdt_stack bins them), a
    # few of its 300 rounds
    rounds = 20
    args, hp, bound, (K, n_max, f_max) = stacked_gbdt_round(
        torch, np, [p[0] for p in parts], [p[1] for p in parts], rounds)
    depth = hp["depth"]
    name = f"gbdt_round_K{K}_n{n_max}_f{f_max}"
    record(name, lambda: train_gbdt(*args, **hp), rounds, *bound)
    onehot_flops = 2 * f_max * 256 * n_max * 3 * ((1 << depth) - 1) * K
    rec = programs[name]
    rec["onehot_lowering_tflops"] = onehot_flops / (rec["device_us_per_step"] / 1e6) / 1e12
    print(f"    the onehot lowering's products: {onehot_flops / 1e9:.3f} GFLOP a round, "
          f"{rec['onehot_lowering_tflops']:.3f} TFLOP/s over the round's device time")
    # the same rounds with each fold's sigmoid taken over its own rows, as
    # fit_gbdt_stack does on the CPU only (2K more launches a round)
    per_fold = lambda: train_gbdt(*args, n_rows=[len(p[1]) for p in parts], **hp)  # noqa
    record(f"{name}_per_fold_sigmoid", per_fold, rounds, *bound)
    host = {"shared": [], "per_fold": []}
    for _ in range(3):  # in turns, synchronised at both ends
        for key, fn in (("shared", lambda: train_gbdt(*args, **hp)), ("per_fold", per_fold)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host[key].append((time.perf_counter() - t0) * 1e3 / rounds)
    med = {k: sorted(v)[1] for k, v in host.items()}
    rec["host_ms_per_round_in_turns"] = med["shared"]
    programs[f"{name}_per_fold_sigmoid"]["host_ms_per_round_in_turns"] = med["per_fold"]
    print(f"    a round's host time, 3 calls of {rounds} rounds each in turns (median): one "
          f"sigmoid {med['shared']:.3f} ms, per-fold sigmoids {med['per_fold']:.3f} ms")
    return programs


def run_study_path(torch, np, yaml, ap, tmp: Path):
    """Phase 30: the PPMI study-data path at the config's settings on
    seeded synthetic study CSVs of ``STUDY_SUBJECTS`` subjects: build,
    the sweep (seeds x ablations x {logreg, lgbm, mlp}), the report and the
    meaningful suite, each through its script's ``main``; every artifact
    and finite metrics; K1 launched neither as kernel nor plain; then the
    suites' device programs. -> (paths, programs, K1 launches by path)."""
    from pd_fusion_torch.analysis import tabular_checks as tc
    from pd_fusion_torch.scripts import ppmi_build_dataset as build
    from pd_fusion_torch.scripts import ppmi_eval_report as report
    from pd_fusion_torch.scripts import ppmi_meaningful_suite as ms
    from pd_fusion_torch.scripts import ppmi_train_tabular as tt

    t_phase = time.perf_counter()
    study, processed = tmp / "ppmi" / "raw" / "study_data", tmp / "ppmi" / "processed"
    t0 = time.perf_counter()
    counts = tc.write_synthetic_study_data(study, STUDY_SUBJECTS)
    write_s = time.perf_counter() - t0
    cfg = tc.study_config(study, processed, STUDY_CONFIG)
    seeds = cfg["splits"]["seeds"]
    if STUDY_SEEDS is not None:
        print(f"depth cut: the sweep's seeds {seeds} -> {seeds[:STUDY_SEEDS]}")
        cfg["splits"]["seeds"] = seeds = seeds[:STUDY_SEEDS]
    cfg_path = tmp / "ppmi_studydata.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    paths, launches = [], {}

    ap.reset_launch_counts()
    t0 = time.perf_counter()
    build.main(["--config", str(cfg_path)])
    build_s = time.perf_counter() - t0
    require_files(processed, ["ppmi_subject_baseline.csv", "ppmi_visit_level.csv",
                              "ppmi_feature_schema.json", "ppmi_manifest.md",
                              "ppmi_build_dataset.log"]
                  + [f"ppmi_splits_seed{s}.json" for s in seeds], "ppmi_build_dataset")
    import pandas as pd

    base = pd.read_csv(processed / "ppmi_subject_baseline.csv", low_memory=False)
    got = base["label"].value_counts().to_dict()
    if got != {1: counts["n_pd"], 0: counts["n_hc"]}:
        raise RuntimeError(f"baseline labels {got}, wrote {counts}")
    schema = json.loads((processed / "ppmi_feature_schema.json").read_text())
    widths = {g: len(v["features"]) for g, v in schema["groups"].items()}
    print(f"ppmi_build_dataset: {len(base)} subjects ({counts['n_pd']} PD, {counts['n_hc']} HC; "
          f"{counts['n_excluded']} SWEDD/prodromal excluded), {schema['n_visits']} visits, feature "
          f"groups {widths}; CSVs written in {write_s:.3f} s, build {build_s:.3f} s")
    launches["ppmi_build_dataset"] = dict(ap.launch_counts)
    paths.append({"name": "ppmi_build_dataset", "wall_s": build_s, "subjects": len(base),
                  "visits": schema["n_visits"], "widths": widths})

    run = tmp / "ppmi" / "tabular_run"
    ap.reset_launch_counts()
    t0 = time.perf_counter()
    results = tt.main(["--config", str(cfg_path), "--out_dir", str(run)])
    train_s = time.perf_counter() - t0
    n_fits = len(seeds) * len(cfg["ablations"]) * len(cfg["models"])
    require_files(run, ["config_resolved.yaml", "results_all.csv", "summary_sweep_mean.csv",
                        "ppmi_train_tabular.log"]
                  + [f"pred_{m}_{a['name']}_seed{s}.csv" for s in seeds for a in cfg["ablations"]
                     for m in cfg["models"]], "ppmi_train_tabular")
    on_disk = pd.read_csv(run / "results_all.csv")
    _finite(on_disk, "results_all.csv")
    if len(on_disk) != n_fits or len(results) != n_fits:
        raise RuntimeError(f"results_all.csv has {len(on_disk)} rows, expected {n_fits}")
    timing = dict(tt.LAST_TIMINGS)
    print(f"ppmi_train_tabular ({len(seeds)} seeds x {len(cfg['ablations'])} ablations x "
          f"{cfg['models']}, MLP {cfg['mlp']['hidden_dims']}, {cfg['mlp']['max_epochs']} epochs, "
          f"patience {cfg['mlp']['patience']}): wall {train_s:.3f} s; "
          + ", ".join(f"{k} {v:.3f}" for k, v in timing.items()))
    for (model, abl), g in on_disk.groupby(["model", "ablation"]):
        print(f"  {model:6s} {abl:16s} roc_auc {g['roc_auc'].mean():.4f} +- "
              f"{g['roc_auc'].std():.4f}")
    launches["ppmi_train_tabular"] = dict(ap.launch_counts)
    paths.append({"name": "ppmi_train_tabular", "wall_s": train_s, "fits": n_fits,
                  "stages_s": timing, "seeds": len(seeds),
                  "auc_full_fusion": {m: float(on_disk[(on_disk.model == m) & (
                      on_disk.ablation == "full_fusion")]["roc_auc"].mean())
                      for m in cfg["models"]}})

    ap.reset_launch_counts()
    t0 = time.perf_counter()
    report.main(["--config", str(cfg_path), "--out_dir", str(run)])
    report_s = time.perf_counter() - t0
    require_files(run, ["ranking_table.csv", "ppmi_eval_report.log"], "ppmi_eval_report")
    ranking = pd.read_csv(run / "ranking_table.csv")
    _finite(ranking[["roc_auc_mean", "roc_auc_std"]], "ranking_table.csv")
    top = ranking.iloc[0]
    print(f"ppmi_eval_report: wall {report_s:.3f} s; top {top['model']}/{top['ablation']} "
          f"roc_auc_mean {top['roc_auc_mean']:.4f}")
    launches["ppmi_eval_report"] = dict(ap.launch_counts)
    paths.append({"name": "ppmi_eval_report", "wall_s": report_s})

    suite = tmp / "ppmi" / "meaningful"
    ap.reset_launch_counts()
    t0 = time.perf_counter()
    per_fold = ms.main(["--input-csv", str(processed / "ppmi_subject_baseline.csv"),
                        "--output-dir", str(suite)])
    suite_s = time.perf_counter() - t0
    require_files(suite, ["kept_dropped_columns.json", "per_fold_metrics.csv",
                          "summary_mean.csv", "feature_importance.csv", "univariate_top.csv",
                          "permutation_test.csv", "ppmi_meaningful_suite.log"]
                  + (["roc_auc_bar.png"] if importlib.util.find_spec("matplotlib") else []),
                  "ppmi_meaningful_suite")
    _finite(pd.read_csv(suite / "per_fold_metrics.csv"), "per_fold_metrics.csv")
    perm = pd.read_csv(suite / "permutation_test.csv")
    _finite(perm, "permutation_test.csv")
    settings = per_fold["setting"].nunique()
    if len(per_fold) != settings * 2 * 5 or settings != len(ms.SETTINGS):
        raise RuntimeError(f"per_fold_metrics.csv: {len(per_fold)} rows over {settings} settings")
    timing = dict(ms.LAST_TIMINGS)
    print(f"ppmi_meaningful_suite (6 settings x {{logreg, lgbm}} x 5 folds, univariate and "
          f"permutation screens): wall {suite_s:.3f} s; "
          + ", ".join(f"{k} {v:.3f}" for k, v in timing.items()))
    summary = pd.read_csv(suite / "summary_mean.csv")
    for _, row in summary.iterrows():
        print(f"  {row['model']:6s} {row['setting']:24s} roc_auc {row['roc_auc_mean']:.4f} +- "
              f"{row['roc_auc_std']:.4f}")
    print(f"  permutation screen AUC mean {perm['roc_auc'].mean():.4f} (labels shuffled)")
    launches["ppmi_meaningful_suite"] = dict(ap.launch_counts)
    paths.append({"name": "ppmi_meaningful_suite", "wall_s": suite_s, "stages_s": timing,
                  "permutation_auc_mean": float(perm["roc_auc"].mean())})
    for name, k1 in launches.items():
        if k1 != {"kernel": 0, "plain": 0}:
            raise RuntimeError(f"{name} launched K1: {k1}")
    if "sklearn" in sys.modules:
        raise RuntimeError("the study-data path imported scikit-learn")
    print(f"phase 30 paths: {time.perf_counter() - t_phase:.3f} s")

    programs = study_programs(torch, np, cfg, processed, seeds)
    return paths, programs, launches


# ---------------------------------------------------------------------------
# the sweep tier and the two PPMI analyses (phases 31-35)
# ---------------------------------------------------------------------------

SWEEP_K = 5
SWEEP_COMPARED = ("fusion_moddrop", "unimodal_clinical")  # fused against standalone
# the fused MIL sweep's seeds: a cut of the sweep tier's 42-44 (depth only)
MIL_SWEEP_SEEDS = (42, 43)
BOOT_N = 1000
IMAGING_CONFIGS = (  # (config, seeds kept: None for all of them)
    ("ppmi_imaging_upgrade.yaml", None),
    ("ppmi_imaging_upgrade_progression.yaml", 1),
    ("ppmi_imaging_upgrade_imaging_available.yaml", 1),
)
IMAGING_ARTIFACTS = (
    "kept_dropped_columns.json", "imaging_columns.json", "imaging_availability_summary.json",
    "imaging_missingness_per_feature.csv", "imaging_missingness_per_subject.csv",
    "covariates_used.json", "per_fold_metrics.csv", "predictions.csv", "summary_mean.csv",
    "feature_importance.csv", "univariate_top.csv", "permutation_test.csv", "paired_tests.json",
    "ppmi_imaging_upgrade.log")
IMAGING_PLOTS = ("roc_auc_bar.png", "roc_curves.png", "calibration_curves.png")


def _has_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _zero_k1(ap, launches, name):
    """K1's counts of the path just run, which must both be 0."""
    k1 = dict(ap.launch_counts)
    if k1 != {"kernel": 0, "plain": 0}:
        raise RuntimeError(f"{name} launched K1: {k1}")
    launches[name] = k1


def run_mil_sweep(yaml, ap, tmp: Path, manifest: Path):
    """Phase 31: ``run_multi_seed_cv`` with ``mil_attention`` over the bags
    of phase 16, on phase 17's config (nested calibration off: the sweep
    hands the engine explicit fold masks, which nested calibration refuses,
    as in the JAX package), seeds ``MIL_SWEEP_SEEDS``; K1's launches on
    this path; seed 42's fused predictions against its standalone run. ->
    (path record, K1 kernel launches)."""
    from pd_fusion_torch.analysis import sweep_checks as sc
    from pd_fusion_torch.parallel.seed_sweep import run_multi_seed_cv

    config_path, _ = data_config_copy(yaml, MIL_CONFIG, tmp, manifest,
                                      tmp / "embeddings_resnet2d", "mil_sweep")
    cfg = yaml.safe_load(config_path.read_text())
    cfg["nested_calibration"] = False
    data_config = yaml.safe_load(Path(cfg["data_config"]).read_text())
    eval_config = yaml.safe_load((ROOT / cfg["eval_config"]).read_text())
    k = int(cfg["cv_folds"])
    print(f"depth cut: the fused MIL sweep's seeds {list(MIL_SWEEP_SEEDS)} of the sweep tier's "
          f"42-44; nested calibration off (explicit fold masks)")
    ap.reset_launch_counts()
    t0 = time.perf_counter()
    out, sweep_dir = run_multi_seed_cv(dict(cfg), data_config, eval_config,
                                       seeds=list(MIL_SWEEP_SEEDS), k=k, synthetic=False,
                                       sweep_dir=tmp / "mil_sweep")
    wall = time.perf_counter() - t0
    k1 = dict(ap.launch_counts)
    if k1["kernel"] <= 0 or k1["plain"] != 0:
        raise RuntimeError(f"the fused MIL sweep: K1 launches {k1}")
    for seed in MIL_SWEEP_SEEDS:
        require_files(sweep_dir / f"mil_attention_s{seed}",
                      ["results_aggregated.yaml", "resolved_config.yaml", "provenance.yaml"]
                      + [f"results_fold_{i}.yaml" for i in range(1, k + 1)]
                      + [f"preds_fold_{i}_full_observation.csv" for i in range(1, k + 1)],
                      f"the fused MIL sweep, seed {seed}")
    aucs = {s: out[s]["full_observation"]["roc_auc"]["mean"] for s in MIL_SWEEP_SEEDS}
    if not all(math.isfinite(a) for a in aucs.values()):
        raise RuntimeError(f"the fused MIL sweep: ROC-AUC {aucs}")
    t0 = time.perf_counter()
    gaps = sc.standalone_gaps(cfg, data_config, eval_config, MIL_SWEEP_SEEDS[:1], k, sweep_dir,
                              synthetic=False)
    standalone_s = time.perf_counter() - t0
    print(f"fused MIL sweep ({len(MIL_SWEEP_SEEDS)} seeds x {k} group folds, "
          f"configs/openneuro_ds001907_resnet2d_mil.yaml on phase 16's bags): wall {wall:.3f} s, "
          f"K1 launches {k1['kernel']}, plain 0; full_observation ROC-AUC by seed "
          f"{ {s: round(a, 4) for s, a in aucs.items()} }; seed 42 fused vs standalone "
          f"(ragged group folds pad to the sweep's widest) max abs diff {gaps[42]:.3e} "
          f"(standalone {standalone_s:.3f} s)")
    return ({"name": "mil_fused_sweep", "wall_s": wall, "seeds": len(MIL_SWEEP_SEEDS), "folds": k,
             "k1_launches": k1["kernel"], "auc_by_seed": aucs,
             "fused_vs_standalone_max_abs_diff_s42": gaps[42]}, k1["kernel"])


def _flat_runs(sweep_dir: Path, flat: Path):
    """Every fused run directory (``<model>/<model_type>_s<seed>``) linked
    into one directory, the layout the sweep's analysis scripts walk."""
    flat.mkdir()
    runs = sorted(d for m in sweep_dir.iterdir() if m.is_dir() and m.name not in ("logs",
                                                                                    "scripts")
                  for d in m.iterdir() if d.is_dir())
    for d in runs:
        (flat / f"{d.parent.name}__{d.name}").symlink_to(d, target_is_directory=True)
    return sorted(flat.iterdir())


def bootstrap_program(torch, programs):
    """The bootstrap's device program at ``sweep_checks.BOOT_SHAPE`` (1,000
    resamples of a model's 1,500 pooled rows): card against CPU on the same
    indices, then timed beside its bound. -> max abs err."""
    from pd_fusion_torch.analysis import sweep_checks as sc
    from pd_fusion_torch.ops.metrics import binary_metrics

    err = sc.check_bootstrap(DEV)
    n, N = sc.BOOT_SHAPE
    y_r, p_r = (t.to(DEV) for t in sc.bootstrap_inputs(n, N))
    fn = lambda: binary_metrics(y_r, p_r)  # noqa: E731
    rec = with_event_time(torch, program_profile(torch, fn), fn, reps=5)
    # each input read once, the six [n] metrics written once; the work: a
    # sort of each resample (about 2 N log2 N operations) and about 60
    # elementwise operations a row over the six metrics
    n_bytes = 2 * n * N * 4 + 6 * n * 4
    ops = n * N * (2 * math.log2(N) + 60)
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_FLOPS * 1e3
    rec.update(bound_ms_per_call=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations", card_vs_cpu_max_abs=err)
    print(f"bootstrap program ({n} resamples x {N} rows, six metrics) card vs CPU on the same "
          f"indices: max abs err {err:.3e} (tolerance {sc.BOOT_ATOL})")
    print_program(f"bootstrap_n{n}_N{N}", rec)
    print(f"    bound {rec['bound_ms_per_call']:.6f} ms a call by {rec['bound_by']}")
    programs[f"bootstrap_n{n}_N{N}"] = rec
    return err


def run_sweep_tier(torch, np, yaml, ap, tmp: Path):
    """Phase 32: ``submit_sweep --local --fused --synthetic --k-fold 5
    --base-config configs/quickstart.yaml`` over the seven models x seeds
    42-44 (every family at its config's widths); fused against standalone
    for ``SWEEP_COMPARED``; their sequential ``--local`` sweeps timed beside
    the fused ones in turns; ``aggregate_results``, ``bootstrap_ci`` (n=1000)
    and ``generate_summary`` on the sweep; the fused trainer's stacked
    step (S x K = 15) profiled; the bootstrap program card vs CPU and
    timed. -> (paths, programs, K1 launches by path)."""
    from pd_fusion_torch.analysis import aggregate_results, bootstrap_ci, generate_summary
    from pd_fusion_torch.analysis import sweep_checks as sc
    from pd_fusion_torch.nn import trainer as TT
    from pd_fusion_torch.paths import RUNS_DIR
    from pd_fusion_torch.scripts import submit_sweep as ss

    paths, programs, launches = [], {}, {}
    base = ["--local", "--synthetic", "--k-fold", str(SWEEP_K), "--base-config", str(QUICKSTART)]
    work = tmp / "fused"
    work.mkdir()
    calls = []
    ap.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.chdir(work), captured(TT, "minibatch_moddrop_impl", calls):
        sweep_dir = work / ss.main(base + ["--fused"])
    wall = time.perf_counter() - t0
    _zero_k1(ap, launches, "fused_tabular_sweep")
    print(f"submit_sweep --local --fused ({len(ss.MODELS)} models x seeds {ss.SEEDS} x "
          f"{SWEEP_K} folds, configs/quickstart.yaml): wall {wall:.3f} s, K1 launches 0")
    aucs = {}
    for model in ss.MODELS:
        runs = sorted((sweep_dir / model).iterdir())
        if len(runs) != len(ss.SEEDS):
            raise RuntimeError(f"the fused sweep of {model}: run directories {runs}")
        for run in runs:
            require_files(run, ["results_aggregated.yaml", "resolved_config.yaml",
                                "provenance.yaml", "eval_config.yaml"]
                          + [f"results_fold_{i}.yaml" for i in range(1, SWEEP_K + 1)]
                          + [f"preds_fold_{i}_full_observation.csv"
                             for i in range(1, SWEEP_K + 1)], f"the fused sweep's {run.name}")
        aggs = [yaml.safe_load((r / "results_aggregated.yaml").read_text()) for r in runs]
        aucs[model] = [a["full_observation"]["roc_auc"]["mean"] for a in aggs]
        if len(aggs[0]) != 6 or not all(math.isfinite(a) for a in aucs[model]):
            raise RuntimeError(f"the fused sweep of {model}: {aucs[model]}")
        print(f"  {model:18s} full_observation ROC-AUC by seed "
              f"{[round(a, 4) for a in aucs[model]]}")
    paths.append({"name": "fused_tabular_sweep", "wall_s": wall, "models": len(ss.MODELS),
                  "seeds": len(ss.SEEDS), "folds": SWEEP_K, "auc_by_model": aucs})

    # fused against standalone, on the card
    data_config = yaml.safe_load((ROOT / "configs" / "data_ppmi.yaml").read_text())
    eval_config = yaml.safe_load(EVAL_CONFIG.read_text())
    gaps = {}
    for model in SWEEP_COMPARED:
        config = yaml.safe_load(QUICKSTART.read_text())
        config.update(ss._model_overrides(model, str(QUICKSTART)))
        gaps[model] = sc.standalone_gaps(config, data_config, eval_config, ss.SEEDS, SWEEP_K,
                                         sweep_dir / model)
        print(f"  {model}: fused vs standalone run_parallel_cv by seed, max abs diff of the "
              f"full-observation probabilities {gaps[model]}")

    # the fused stacked trainer step of fusion_moddrop (S x K = 15)
    fused_call = next(c for c in calls if c[0][1].shape[0] == len(ss.SEEDS) * SWEEP_K)
    w_steps, w_wall, w_dev, w_n, top = trainer_window(torch, fused_call)
    X = fused_call[0][1]
    dims = [X.shape[-1]] + [int(layer["w"].shape[-1]) for layer in fused_call[0][0]]
    n_par = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    S_K, bs = X.shape[0], fused_call[0][8]
    step_bytes = S_K * (n_par * 4 * 8 + bs * dims[0] * 4)  # params, grads, moments; a batch
    step_ops = 6 * S_K * bs * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    t_b, t_o = step_bytes / H100_BYTES_PER_S * 1e3, step_ops / H100_F32_FLOPS * 1e3
    a, kw = fused_call  # the window's 2 epochs again, unprofiled
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    TT.minibatch_moddrop_impl(*(a[:7] + (2,) + a[8:]), **kw)
    torch.cuda.synchronize()
    rec = {"steps": w_steps, "host_us_per_step": (time.perf_counter() - t0) / w_steps * 1e6,
           "profiled_wall_us_per_step": w_wall / w_steps * 1e3,
           "device_us_per_step": w_dev / w_steps * 1e3, "launches_per_step": w_n / w_steps,
           "busy_share": w_dev / w_wall, "bound_ms_per_call": max(t_b, t_o),
           "bound_by": "bytes" if t_b >= t_o else "operations"}
    print_program(f"fused stacked step, fusion_moddrop S x K = {S_K} (widths {dims}, batch {bs})",
                  rec)
    print(f"    bound {rec['bound_ms_per_call']:.6f} ms a step by {rec['bound_by']}")
    for op, ms, count in top:
        print(f"    {ms:10.3f} ms  x{count:<6d} {op}")
    programs[f"fused_step_SK{S_K}"] = rec

    # the sequential sweeps of two models beside their fused ones, in turns
    turns = {m: {"fused": [], "local": []} for m in SWEEP_COMPARED}
    ap.reset_launch_counts()
    for model in SWEEP_COMPARED:
        for i, mode in enumerate(("fused", "local", "local", "fused")):
            d = tmp / f"turn_{model}_{i}"
            d.mkdir()
            argv = base + ["--models", model] + (["--fused"] if mode == "fused" else [])
            t0 = time.perf_counter()
            with contextlib.chdir(d):
                made = ss.main(argv)
            turns[model][mode].append(time.perf_counter() - t0)
            if mode == "local":  # the sequential runs write under the repo's runs/
                done = sorted((RUNS_DIR / made.name).glob(f"{model}_s*/results_aggregated.yaml"))
                shutil.rmtree(RUNS_DIR / made.name, ignore_errors=True)
                if len(done) != len(ss.SEEDS):
                    raise RuntimeError(f"the sequential sweep of {model}: {done}")
        print(f"  {model}: fused {turns[model]['fused']} s, sequential --local "
              f"{turns[model]['local']} s (fused, local, local, fused)")
    _zero_k1(ap, launches, "sweep_in_turns")
    paths.append({"name": "sweep_fused_vs_sequential", "turns_s": turns,
                  "fused_vs_standalone_max_abs_diff": gaps})

    # the sweep's analysis scripts on the fused sweep's 21 run directories
    runs = _flat_runs(sweep_dir, tmp / "all_runs")
    ap.reset_launch_counts()
    stages = {}
    t0 = time.perf_counter()
    agg = aggregate_results.main(["--sweep-dir", str(tmp / "all_runs"), "--output",
                                  str(tmp / "summary.csv")])
    stages["aggregate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ci_path = bootstrap_ci.main(["--sweep-dir", str(tmp / "all_runs"), "--n", str(BOOT_N)])
    stages["bootstrap_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary = generate_summary.main(["--runs", *map(str, runs), "--output", str(tmp / "final")])
    stages["summary_s"] = time.perf_counter() - t0
    _zero_k1(ap, launches, "sweep_analysis")
    require_files(tmp, ["summary.csv", "summary_table.csv", "summary_table.tex"],
                  "aggregate_results")
    require_files(tmp / "final", ["final_benchmark_summary.csv", "summary_table.tex"]
                  + (["robustness_comparison.png"] if _has_matplotlib() else []),
                  "generate_summary")
    import pandas as pd

    ci = pd.read_csv(ci_path)
    n_models = len(ss.MODELS)
    if (len(agg) != len(runs) * 6 or len(ci) != n_models * 6 or len(summary) != len(runs) * 36
            or not (ci["CI_low"] <= ci["CI_high"]).all()):
        raise RuntimeError(f"sweep analysis: {len(agg)} aggregate rows, {len(ci)} CI rows, "
                           f"{len(summary)} summary rows for {len(runs)} runs")
    _finite(ci, "summary_bootstrap_ci.csv")
    auc_ci = ci[ci["Metric"] == "roc_auc"].set_index("Model")
    print(f"aggregate_results, bootstrap_ci (n={BOOT_N}) and generate_summary on the "
          f"{len(runs)} run directories: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; ROC-AUC 95% CIs {auc_ci[['CI_low', 'CI_high']].round(4).to_dict('index')}")
    paths.append({"name": "sweep_analysis", **stages, "runs": len(runs)})
    boot_err = bootstrap_program(torch, programs)
    paths[-1]["bootstrap_card_vs_cpu_max_abs"] = boot_err
    return paths, programs, launches


def run_stress(torch, np, ap, processed: Path, tmp: Path, launches):
    """Phase 33: the stress test at its defaults (5 folds, 30 epochs, batch
    128, moddrop 0.3) on phase 30's baseline table through its ``main``;
    fold 1's MLP training card vs CPU on the same draws; one training step
    timed. -> (path record, programs)."""
    import pandas as pd

    from pd_fusion_torch.analysis import sweep_checks as sc
    from pd_fusion_torch.data.splits import _stratified_kfold
    from pd_fusion_torch.nn.trainer import _step, make_optimizer
    from pd_fusion_torch.scripts import ppmi_stress_test as st

    out = tmp / "stress"
    csv = processed / "ppmi_subject_baseline.csv"
    ap.reset_launch_counts()
    t0 = time.perf_counter()
    per_fold = st.main(["--input-csv", str(csv), "--output-dir", str(out)])
    wall = time.perf_counter() - t0
    _zero_k1(ap, launches, "ppmi_stress_test")
    require_files(out, ["stress_test_per_fold.csv", "stress_test_summary.csv",
                        "ppmi_stress_test.log"]
                  + (["stress_test_roc_auc.png", "stress_test_roc_auc.pdf"]
                     if _has_matplotlib() else []), "ppmi_stress_test")
    _finite(per_fold, "stress_test_per_fold.csv")
    if len(per_fold) != 2 * 3 * 5:
        raise RuntimeError(f"stress_test_per_fold.csv has {len(per_fold)} rows")
    timing = dict(st.LAST_TIMINGS)
    print(f"ppmi_stress_test (defaults: 5 folds, 30 epochs, batch 128, moddrop 0.3): wall "
          f"{wall:.3f} s; " + ", ".join(f"{k} {v:.3f}" for k, v in timing.items()))
    summary = pd.read_csv(out / "stress_test_summary.csv")
    for _, row in summary.iterrows():
        print(f"  {row['model']:12s} {row['scenario']:17s} roc_auc {row['roc_auc_mean']:.4f} +- "
              f"{row['roc_auc_std']:.4f}")

    df = pd.read_csv(csv, low_memory=False).dropna(subset=["label"])
    groups = st.build_groups(df)
    X = st.scaled_features(df, groups["full"])
    col = {c: i for i, c in enumerate(groups["full"])}
    group_idx = {g: [col[c] for c in groups[g]] for g in ("clinical", "imaging")}
    y = df["label"].values.astype(int)
    tr, _ = next(iter(_stratified_kfold(y, 5, 42)))
    inputs = sc.stress_fold_inputs(X[tr], y[tr], group_idx, 42 + 1)
    t0 = time.perf_counter()
    w_err, p_err = sc.check_stress_training(DEV, inputs)
    print(f"stress MLP, fold 1 ({len(tr)} x {X.shape[1]}, 30 epochs, batch 128) card vs CPU on "
          f"the same draws: weights {w_err:.3e}, probabilities {p_err:.3e} (tolerance "
          f"{sc.FULL_ATOL}; {time.perf_counter() - t0:.3f} s)")

    a = sc._to(inputs, DEV)
    p = [{k: v.clone().requires_grad_(True) for k, v in layer.items()} for layer in a["params"]]
    leaves = [layer[k] for layer in p for k in ("w", "b")]
    opt = make_optimizer(leaves, 1e-3)
    bs = a["batch_size"]
    idx = a["draws"][0][0, :bs].to(torch.long)
    wb = torch.ones(bs, device=DEV)
    keep, dk = a["draws"][1][0, 0], [d[0, 0] for d in a["draws"][2]]

    def step():
        _step(opt, leaves, st.moddrop_loss(p, a["X"][idx], a["y"][idx], wb, keep, dk,
                                           a["clin"], a["img"]))

    rec = with_event_time(torch, program_profile(torch, step), step, reps=20)
    F = X.shape[1]
    dims = [F + 2, *st.HIDDEN, 1]
    n_par = sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))
    t_b = (n_par * 4 * 8 + bs * F * 4) / H100_BYTES_PER_S * 1e3
    t_o = 6 * bs * sum(i * o for i, o in zip(dims[:-1], dims[1:])) / H100_F32_FLOPS * 1e3
    rec.update(bound_ms_per_call=max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations")
    name = f"stress_mlp_step_bs{bs}_F{F}"
    print_program(name, rec)
    print(f"    bound {rec['bound_ms_per_call']:.6f} ms a step by {rec['bound_by']}")
    return ({"name": "ppmi_stress_test", "wall_s": wall, "stages_s": timing,
             "card_vs_cpu_weights": w_err, "card_vs_cpu_probs": p_err,
             "auc": {f"{r['model']}/{r['scenario']}": r["roc_auc_mean"]
                     for _, r in summary.iterrows()}},
            {name: rec})


def treeshap_chunk(torch, np, X, y, programs):
    """One TreeSHAP chunk (``ops/treeshap.py::_shap_chunk``, 256 rows) of a
    device GBDT with the suites' settings fitted on ``X``: device and host
    time, launches, beside the bound."""
    from pd_fusion_torch.analysis.tabular import SUITE_GBDT
    from pd_fusion_torch.nn.gbdt import DeviceHistGBDT, bin_features
    from pd_fusion_torch.ops import treeshap

    model = DeviceHistGBDT(**SUITE_GBDT).fit(X, y)
    trees = model._device_trees()
    n = min(treeshap._CHUNK, len(X))
    bins = torch.as_tensor(bin_features(np.asarray(X[:n], np.float32), model.edges_),
                           device=DEV).to(torch.int64)
    fn = lambda: treeshap._shap_chunk(trees, bins, model.max_depth, X.shape[1])  # noqa: E731
    rec = with_event_time(torch, program_profile(torch, fn), fn, reps=3)
    D = model.max_depth
    L = 1 << D
    # the dense coalition block of every tree: N x 2^D leaves x 2^D masks,
    # D reach products and a contraction over it (about 2D + 4 operations)
    ops = model.n_estimators * n * L * L * (2 * D + 4)
    n_bytes = (bins.numel() * 8 + n * X.shape[1] * 4
               + sum(v.numel() * v.element_size() for v in trees.values()))
    t_b, t_o = n_bytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_FLOPS * 1e3
    rec.update(bound_ms_per_call=max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations",
               trees=model.n_estimators, depth=D, rows=n, features=X.shape[1])
    name = f"treeshap_chunk_{n}rows_{model.n_estimators}trees_F{X.shape[1]}"
    print_program(name, rec)
    print(f"    bound {rec['bound_ms_per_call']:.6f} ms a chunk by {rec['bound_by']}")
    programs[name] = rec


def run_imaging(torch, np, yaml, ap, processed: Path, tmp: Path, launches):
    """Phase 34: ``ppmi_imaging_upgrade`` through its ``main`` on phase 30's
    tables: ``configs/ppmi_imaging_upgrade.yaml`` uncut (3 seeds x 5 folds x
    4 settings x logreg/lgbm, SHAP on), the ``_progression`` and
    ``_imaging_available`` configs at one seed each (a cut); every artifact,
    finite metrics, each stage's wall and the TreeSHAP leg; then a GBDT
    round of the upgrade's stacked fit and a TreeSHAP chunk profiled. ->
    (paths, programs)."""
    import pandas as pd

    from pd_fusion_torch.data.splits import _stratified_kfold
    from pd_fusion_torch.nn.gbdt import train_gbdt
    from pd_fusion_torch.scripts import ppmi_imaging_upgrade as iu

    paths, programs = [], {}
    runs = [(name, keep, name.replace(".yaml", ""), {}) for name, keep in IMAGING_CONFIGS]
    while runs:
        name, keep, stem, extra = runs.pop(0)
        cfg = yaml.safe_load((ROOT / "configs" / name).read_text())
        cfg.update(baseline_csv=str(processed / "ppmi_subject_baseline.csv"),
                   visit_csv=str(processed / "ppmi_visit_level.csv"), **extra)
        if keep is not None:
            print(f"depth cut: {name}'s seeds {cfg['cv']['seeds']} -> {cfg['cv']['seeds'][:keep]}")
            cfg["cv"]["seeds"] = cfg["cv"]["seeds"][:keep]
        path = tmp / f"{stem}.yaml"
        path.write_text(yaml.safe_dump(cfg, sort_keys=False))
        out = tmp / stem
        ap.reset_launch_counts()
        t0 = time.perf_counter()
        per_fold = iu.main(["--config", str(path), "--out-dir", str(out)])
        wall = time.perf_counter() - t0
        _zero_k1(ap, launches, stem)
        summary = pd.read_csv(out / "summary_mean.csv")
        winner = summary.sort_values("roc_auc_mean", ascending=False).iloc[0]
        require_files(out, list(IMAGING_ARTIFACTS)
                      + (list(IMAGING_PLOTS) if _has_matplotlib() else [])
                      + (["shap_summary.csv"] if winner["model"] == "lgbm" else []), stem)
        _finite(per_fold, f"{stem} per_fold_metrics.csv")
        n_rows = (len(cfg["cv"]["seeds"]) * 4 * int(cfg["cv"]["folds"])
                  * len(cfg.get("models", ["logreg", "lgbm"])))
        if len(per_fold) != n_rows:
            raise RuntimeError(f"{stem}: {len(per_fold)} fold rows, expected {n_rows}")
        timing, shap = dict(iu.LAST_TIMINGS), dict(iu.LAST_SHAP)
        cohort = pd.read_csv(out / "predictions.csv")["subject_id"].nunique()
        print(f"{stem} ({len(cfg['cv']['seeds'])} seeds x {cfg['cv']['folds']} folds x 4 settings "
              f"x {cfg.get('models', ['logreg', 'lgbm'])}, {cohort} subjects): wall {wall:.3f} s; "
              + ", ".join(f"{k} {v:.3f}" for k, v in timing.items())
              + f"; winner {winner['setting']}/{winner['model']} roc_auc_mean "
              f"{winner['roc_auc_mean']:.4f}; SHAP leg {shap or 'skipped (logistic winner)'}")
        for _, row in summary.iterrows():
            print(f"  {row['model']:6s} {row['setting']:24s} roc_auc {row['roc_auc_mean']:.4f} +- "
                  f"{row['roc_auc_std']:.4f}")
        paths.append({"name": stem, "wall_s": wall, "stages_s": timing, "shap": shap,
                      "subjects": int(cohort), "winner": f"{winner['setting']}/{winner['model']}",
                      "winner_auc": float(winner["roc_auc_mean"])})
        if not runs and not any(p["shap"] for p in paths) and not extra:
            # every winner was logistic: the TreeSHAP leg runs on a tree-only
            # run of the uncut config's settings at one seed (a cut)
            print("the logistic fits won every run: the TreeSHAP leg runs once more with "
                  "models: [lgbm] (as the JAX package's SHAP test), one seed")
            runs.append((IMAGING_CONFIGS[0][0], 1, "ppmi_imaging_upgrade_tree_shap",
                         {"models": ["lgbm"]}))
    if not any(p["shap"] for p in paths):
        raise RuntimeError("the imaging upgrade's TreeSHAP leg did not run")

    # the device programs of the uncut config at seed 42: its stacked GBDT
    # fit (every setting's folds, prepared as the script prepares them:
    # residualized on train, then imputed with indicators) and a TreeSHAP
    # chunk of the widest setting (the fusion of non-motor and imaging
    # columns)
    import logging

    cfg = yaml.safe_load((ROOT / "configs" / IMAGING_CONFIGS[0][0]).read_text())
    cov = {k: cfg["covariates"].get(k, []) for k in ("numeric", "categorical")}
    harm = {"method": cfg["harmonization"]["method"],
            "site_cols": cfg["harmonization"]["site_cols"]}
    run_dir = tmp / IMAGING_CONFIGS[0][0].replace(".yaml", "")
    imaging = json.loads((run_dir / "imaging_columns.json").read_text())
    kept = json.loads((run_dir / "kept_dropped_columns.json").read_text())
    base = pd.read_csv(processed / "ppmi_subject_baseline.csv", low_memory=False)
    base["subject_id"] = base["subject_id"].astype(str)
    base, _ = iu.with_asymmetry(base.dropna(subset=["label"]),
                                [c for c in imaging["datsbr"] if not c.endswith("_ASYM")])
    imaging_cols = set(imaging["datsbr"] + imaging["mri"])
    splits = list(_stratified_kfold(base["label"].values, 5, 42))
    parts = {}
    for setting, cols in ((k, v["kept"]) for k, v in kept.items() if v["kept"]):
        parts[setting] = []
        for tr, te in splits:
            tr_df, _, _, unscaled = iu.prepare_setting_fold(
                base.iloc[tr].copy(), base.iloc[te].copy(), cols,
                [c for c in cols if c in imaging_cols], cov, harm, logging.getLogger("chip_smoke"))
            parts[setting].append((unscaled.transform(tr_df), tr_df["label"].values))
    stacked = [p for ps in parts.values() for p in ps]
    rounds = 20
    args, hp, bound, (K, n_max, f_max) = stacked_gbdt_round(
        torch, np, [p[0] for p in stacked], [p[1] for p in stacked], rounds)
    rec = with_event_time(torch, program_profile(torch, lambda: train_gbdt(*args, **hp),
                                                 steps=rounds),
                          lambda: train_gbdt(*args, **hp), reps=3)
    rec.update(bound_ms_per_call=bound[0], bound_by=bound[1], rounds_a_call=rounds)
    name = f"imaging_gbdt_round_K{K}_n{n_max}_f{f_max}"
    print_program(name + f" ({len(parts)} settings x 5 folds, widths "
                  f"{ {k: v[0][0].shape[1] for k, v in parts.items()} })", rec)
    print(f"    bound {bound[0]:.6f} ms a call of {rounds} rounds by {bound[1]}")
    programs[name] = rec
    X, y = parts["fusion_nonmotor_imaging"][0]
    treeshap_chunk(torch, np, X, y, programs)
    return paths, programs


def run_submitters_dry(tmp: Path):
    """Phase 35: both submitters' ``--dry-run`` through their ``main`` with
    ``subprocess.run`` refusing: the SLURM scripts they write. -> path
    record."""
    import subprocess
    from unittest import mock

    from pd_fusion_torch.scripts import submit_dual_h200, submit_sweep

    def refuse(cmd, *a, **kw):
        raise RuntimeError(f"a dry run tried to run {cmd}")

    tmp.mkdir()
    with contextlib.chdir(tmp), mock.patch.object(subprocess, "run", refuse):
        sweep = tmp / submit_sweep.main(["--dry-run", "--synthetic", "--k-fold", str(SWEEP_K)])
        dual = tmp / submit_dual_h200.main(["--dry-run", "--dataset", "ppmi", "--synthetic",
                                            "--k-fold", str(SWEEP_K)])
    scripts = sorted((sweep / "scripts").glob("*.sh"))
    texts = [p.read_text() for p in scripts]
    want = len(submit_sweep.MODELS) * len(submit_sweep.SEEDS)
    if len(scripts) != want or not all(
            "#SBATCH --partition=gpu\n#SBATCH --gres=gpu:1\n" in t
            and "python -m pd_fusion_torch.cli run" in t and f"--k-fold {SWEEP_K}" in t
            for t in texts):
        raise RuntimeError(f"submit_sweep --dry-run wrote {len(scripts)} scripts, not {want} "
                           "asking for a card")
    jobs = sorted((dual / "scripts").glob("*.sh"))
    joined = "".join(p.read_text() for p in jobs)
    runs = len(submit_dual_h200.MODELS) * len(submit_dual_h200.SEEDS)
    if len(jobs) != 2 or joined.count("python -m pd_fusion_torch.cli run") != runs or \
            joined.count("#SBATCH --gres=gpu:1") != 2:
        raise RuntimeError(f"submit_dual_h200 --dry-run wrote {len(jobs)} jobs")
    print(f"submit_sweep --dry-run: {len(scripts)} SLURM scripts (partition gpu, one card each); "
          f"submit_dual_h200 --dry-run: {len(jobs)} jobs holding {runs} runs; nothing submitted")
    return {"name": "submitters_dry_run", "sweep_scripts": len(scripts), "dual_jobs": len(jobs)}


def _tensors(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# the multi-device tier on one card (phases 36-37)
# ---------------------------------------------------------------------------

DIST_CHILD_TIMEOUT_S = 300  # a child that hangs is killed and fails the smoke
DIST_COLLECTIVE_TIMEOUT_S = "120"  # the children's process-group timeout
GLOO = {"PD_FUSION_TORCH_DIST_BACKEND": "gloo"}
# the CLI's bands against the one-rank run (tests/test_multichip.py's)
PROB_BAND, METRIC_BAND = 5e-3, 5e-2
TOL_EMBED = 5e-5  # per-subject embeddings, sharded against one rank (the dry run's)
DRYRUN_SIZE = "full"  # the MIL-FT leg at the fine-tune config's width


def start_torchrun(nproc: int, args, env_extra=None):
    """``torchrun --standalone --nproc-per-node nproc <args>`` from the
    repo's root, in a session of its own (so a timeout kills every rank)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PD_FUSION_TORCH_DIST_TIMEOUT=DIST_COLLECTIVE_TIMEOUT_S)
    env.pop("PD_FUSION_TORCH_DIST_BACKEND", None)
    env.update(env_extra or {})
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", *map(str, args)]
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)


def finish_torchrun(proc, what, expect_ok=True):
    """Wait for a ``start_torchrun`` child (killing its whole session after
    ``DIST_CHILD_TIMEOUT_S``). -> (wall s, stdout, stderr); raises when it
    exits otherwise than ``expect_ok`` says."""
    import os
    import signal

    t0 = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=DIST_CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"{what}: no end after {DIST_CHILD_TIMEOUT_S} s; killed")
    if (proc.returncode == 0) != expect_ok:
        raise RuntimeError(f"{what}: torchrun exited {proc.returncode}\n{out[-3000:]}\n"
                           f"{err[-6000:]}")
    return time.perf_counter() - t0, out, err


def run_torchrun(nproc, args, what, env_extra=None):
    t0 = time.perf_counter()
    _, out, err = finish_torchrun(start_torchrun(nproc, args, env_extra), what)
    return time.perf_counter() - t0, out, err


def bench_frame_results(yaml, np, out: Path, k: int):
    """A K-fold run's per-fold metrics and full-observation probabilities."""
    import pandas as pd

    folds = [yaml.safe_load((out / f"results_fold_{i}.yaml").read_text())
             for i in range(1, k + 1)]
    probs = [pd.read_csv(out / f"preds_fold_{i}_full_observation.csv")["y_prob"].to_numpy()
             for i in range(1, k + 1)]
    return {"folds": folds, "probs": probs}


def frame_gaps(np, a, b):
    """(max |prob diff|, max |metric diff|) between two K-fold results."""
    p = max(float(np.max(np.abs(x - y))) for x, y in zip(a["probs"], b["probs"]))
    m = max(abs(fa[scen][metric] - fb[scen][metric])
            for fa, fb in zip(a["folds"], b["folds"]) for scen in fa if scen != "fold"
            for metric in fa[scen])
    return p, m


def run_backend_rule_and_nccl(torch):
    """Phases 36 and 37(a), side by side: two ranks on the one card without
    a backend named must refuse NCCL and name the variable; one rank
    initialises NCCL and holds ``all_reduce``, ``all_gather`` and
    ``broadcast`` on CUDA tensors to their known answers."""
    refusal = start_torchrun(2, ["-m", "pd_fusion_torch.parallel.distributed"])
    nccl = start_torchrun(1, ["-m", "pd_fusion_torch.parallel.distributed"])
    wall, out, _ = finish_torchrun(nccl, "NCCL at world 1")
    _, r_out, r_err = finish_torchrun(refusal, "NCCL with two ranks on one card",
                                      expect_ok=False)
    if "PD_FUSION_TORCH_DIST_BACKEND=gloo" not in r_out + r_err:
        raise RuntimeError("two ranks on one card did not raise the backend rule's error:\n"
                           + (r_out + r_err)[-3000:])
    print("phase 36: two ranks on one card with no backend named: both refused before NCCL "
          "started (the error names PD_FUSION_TORCH_DIST_BACKEND=gloo)")
    rec = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
    if rec["backend"] != "nccl" or rec["world_size"] != 1:
        raise RuntimeError(f"NCCL at world 1 gave {rec}")
    print(f"phase 37(a): NCCL {rec['nccl']} at world 1 on {rec['device']}: all_reduce, "
          f"all_gather and broadcast on CUDA tensors hold their known answers; wall {wall:.3f} s "
          f"(torchrun, one process)")
    return rec


def dist_child(spec_path) -> int:
    """Phase 37(b)-(c)'s ``torchrun`` child, on every rank (``chip_smoke.py
    --dist-child SPEC``): the dry run, the MIL bag build and the bench CV
    frame through the CLI, one after the other in one process group (one
    start for the three). Each part's wall is taken between barriers; rank
    0 writes them and the CV engine's wall to ``spec["out"]``."""
    from pd_fusion_torch import cli
    from pd_fusion_torch.parallel import distributed, dryrun
    from pd_fusion_torch.scripts import build_resnet2d_mil_embeddings as bag_build
    from pd_fusion_torch.utils.profiling import get_phase_times

    spec = json.loads(Path(spec_path).read_text())
    walls = {}
    with distributed.process_group(kernels=True, host=True):
        for name, run in (("dryrun", dryrun.main), ("bag_build", bag_build.main),
                          ("bench_cv", cli.main)):
            distributed.barrier()
            t0 = time.perf_counter()
            run(spec[name])
            distributed.barrier()
            walls[name] = time.perf_counter() - t0
        if distributed.is_primary():
            Path(spec["out"]).write_text(json.dumps(
                {"walls": walls, "parallel_cv_s": get_phase_times()["parallel_cv"]}))
    return 0


def run_dist_tier(torch, np, yaml, tmp: Path, manifest: Path, bench_ref, card):
    """Phase 37(b)-(c), in one ``torchrun`` child of 2 ranks over gloo, both
    on cuda:0 (``dist_child``): the dry run, the MIL-FT leg at full width;
    the MIL bag build at world 2 against phase 16's bags; the bench CV
    frame through the CLI at world 2 against phase 7's run. -> (paths
    record, K1 launches of the data-parallel fine-tune step)."""
    label = f"2 ranks sharing one card over gloo ({card})"
    mil_cfg = yaml.safe_load(MIL_DATA.read_text())["resnet2d_config"]
    dry_out, w2_cache, cv_dir = tmp / "dryrun_w2.json", tmp / "embeddings_resnet2d_w2", \
        tmp / "bench_cv_w2"
    spec = {"dryrun": ["--size", DRYRUN_SIZE, "--mesh", "2x1,1x2", "--out", str(dry_out)],
            "bag_build": script_argv(mil_cfg, manifest, w2_cache),
            "bench_cv": ["run", "--config", str(QUICKSTART), "--synthetic", "--k-fold", "5",
                         "--model", "fusion_moddrop", "--output-dir", str(cv_dir)],
            "out": str(tmp / "dist_child.json")}
    (tmp / "dist_child_spec.json").write_text(json.dumps(spec))
    wall_child, out, _ = run_torchrun(2, [Path(__file__).resolve(), "--dist-child",
                                          tmp / "dist_child_spec.json"],
                                      "the dry run, bag build and bench CV at world 2", GLOO)
    child = json.loads(Path(spec["out"]).read_text())
    print(f"phase 37(b)-(c) torchrun child of 2 ranks: {wall_child:.3f} s with both "
          f"processes' start; parts {json.dumps({k: round(v, 3) for k, v in child['walls'].items()})} s")

    # (b) the dry run: the CV-engine legs on both meshes of 2 ranks
    print("\n".join(ln for ln in out.splitlines() if ln.startswith("dryrun_multichip")))
    dry = json.loads(dry_out.read_text())
    if DEV == "cuda" and not all(n > 0 for n in dry["k1_launches"]):  # the CPU runs plain
        raise RuntimeError(f"K1 did not launch on every rank of the MIL-FT step: {dry}")
    walls = dry["walls"]
    print(f"phase 37(b) dry run, {label}: {child['walls']['dryrun']:.3f} s; "
          f"MIL-FT step ({dry['ft_arch']}, {dry['ft_px']}^2, {dry['ft_bags']} bags x "
          f"{dry['ft_slices']} slices, unfrozen): world-1 {walls['mil_ft_world1_s']:.3f} s, "
          f"world-2 {walls['mil_ft_sharded_s']:.3f} s; its all-reduced float64 gradients "
          f"{dry['diffs']['mil_ft_grads']:.3e} (relative) off the world-1 step's, in "
          f"{walls['mil_ft_grads_world1_s']:.3f} and {walls['mil_ft_grads_sharded_s']:.3f} s; "
          f"K1 launches by "
          f"rank {dry['k1_launches']}; peak device memory by rank "
          f"{[round(m, 1) for m in dry['peak_mib']]} MiB; CNN3D world-1 "
          f"{walls['cnn3d_world1_s']:.3f} s, world-2 {walls['cnn3d_sharded_s']:.3f} s; replicas "
          f"bitwise equal {dry['replicas_equal']}")
    print(f"  walls (s): {json.dumps({k: round(v, 4) for k, v in walls.items()})}")

    # (b) the MIL bag build over phase 14's volumes at world 2, against phase 16's bags
    (one,), (two,) = list((tmp / "embeddings_resnet2d").glob("*.npz")), list(
        w2_cache.glob("*.npz"))
    if one.name != two.name:
        raise RuntimeError(f"the world-2 build's cache name {two.name} is not {one.name}")
    with np.load(one, allow_pickle=True) as a, np.load(two, allow_pickle=True) as b:
        if list(a["subject_id"]) != list(b["subject_id"]):
            raise RuntimeError("the world-2 bags are not in the manifest's subject order")
        bag_err = float(np.max(np.abs(a["embeddings"] - b["embeddings"])))
        n_bags = len(a["embeddings"])
    if not bag_err <= TOL_EMBED:
        raise RuntimeError(f"the world-2 MIL bags differ from phase 16's by {bag_err}")
    wall_bags = child["walls"]["bag_build"]
    print(f"phase 37(b) MIL bag build over {n_bags} volumes, {label}: {wall_bags:.3f} s "
          f"(phase 16, one process: {bench_ref['bag_wall_s']:.3f} s), max |emb diff| against "
          f"phase 16's bags {bag_err:.3e} (tolerance {TOL_EMBED})")

    # (c) the bench CV frame through the CLI at world 2, against phase 7's run
    # in this process (world 1)
    res = bench_frame_results(yaml, np, cv_dir, 5)
    prov = yaml.safe_load((cv_dir / "provenance.yaml").read_text())["env"]
    p_gap, m_gap = frame_gaps(np, res, bench_ref["cv5"])
    if not (p_gap < PROB_BAND and m_gap < METRIC_BAND) or prov["world_size"] != 2:
        raise RuntimeError(f"the bench CV frame at world 2 is {p_gap}, {m_gap} off phase 7 "
                           f"({prov})")
    wall, cv_s = child["walls"]["bench_cv"], child["parallel_cv_s"]
    cv = {"wall_s": wall, "parallel_cv_s": cv_s, "prob_gap": p_gap, "metric_gap": m_gap,
          "world_size": prov["world_size"], "backend": prov["dist_backend"],
          "world1_parallel_cv_s": bench_ref["cv5_parallel_cv_s"]}
    print(f"phase 37(c) bench CV frame (--k-fold 5, fusion_moddrop) at world 2 "
          f"({prov['dist_backend']}, {label}): {wall:.3f} s, the CV engine {cv_s:.3f} s (world "
          f"1, phase 7 in this process: {bench_ref['cv5_parallel_cv_s']:.3f} s); against phase "
          f"7's run: max |prob diff| {p_gap:.3e}, max |metric diff| {m_gap:.3e} (bands "
          f"{PROB_BAND}, {METRIC_BAND})")
    rec = {"name": "multi_device_tier_one_card", "label": label, "dryrun": dry,
           "child_wall_s": wall_child, "dryrun_wall_s": child["walls"]["dryrun"],
           "bag_build_w2_wall_s": wall_bags, "bag_build_w2_max_abs_err": bag_err,
           "bench_cv_w2": cv}
    return rec, sum(dry["k1_launches"])


# ---------------------------------------------------------------------------
# every device program run twice; the CLI's runs again in a fresh process
# (phase 39)
# ---------------------------------------------------------------------------

def print_determinism(row):
    expect = "deterministic" if row["deterministic"] else f"by design: {row['note']}"
    flagged = ", ".join(row["flagged"]) if isinstance(row["flagged"], list) else row["flagged"]
    print(f"phase 39: {row['name']}: equal twice {'yes' if row['equal'] else 'no'}, max gap "
          f"{row['gap']:.3e}, flagged {flagged or 'none'}, {row['source']}; {row['width']}; "
          f"{expect}; {row['two_runs_s']:.3f} s")


TURNS_PROGRAMS = ("cnn3d_train_step", "ft_step_unfrozen")  # phase 39(c) times them again


def determinism_programs(torch, ap, progs=None, kept=None):
    """Phase 39(a): every device program of the port's paths twice from the
    same inputs and state, then once under the deterministic mode for the
    ops PyTorch flags (``utils/determinism_checks.py``). K1's counts are
    zeroed before and read after; the programs of ``TURNS_PROGRAMS`` are
    kept in ``kept``. Raises, after printing every program's line, when a
    program listed as deterministic gave two different results. ->
    (records, K1 launches)."""
    from pd_fusion_torch.utils import determinism_checks as dc

    def keeping(programs):
        for prog in programs:
            if kept is not None and prog.name in TURNS_PROGRAMS:
                kept[prog.name] = prog
            yield prog

    ap.reset_launch_counts()
    rows = dc.audit(keeping(dc.programs(DEV) if progs is None else progs))
    k1 = dict(ap.launch_counts)
    for row in rows:
        print_determinism(row)
    if DEV == "cuda" and progs is None and (k1["kernel"] <= 0 or k1["plain"] != 0):
        raise RuntimeError(f"phase 39's MIL programs did not run K1 alone: {k1}")
    failed = dc.failures(rows)
    if failed:
        raise RuntimeError("programs listed as deterministic differ between two runs: "
                           + "; ".join(failed))
    return rows, k1["kernel"]


@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` is ``value`` inside the block."""
    before = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, before)


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN limited to its deterministic algorithms inside the block."""
    with patched(torch.backends.cudnn, "deterministic", True):
        yield


def forms_in_turns(torch, forms, fn, make_state, reps=5, rounds=2):
    """``fn(make_state())`` under each of ``forms`` (name -> context
    factory), in turns (a, b, b, a, a, b, ...: ``rounds`` blocks each): a
    warm-up call, then ``reps`` calls a block, each between its own CUDA
    events with its state built before them. -> name -> [median ms of
    each block]."""
    times = {name: [] for name in forms}
    order = list(forms)
    for name in [n for r in range(rounds) for n in (order if r % 2 == 0 else order[::-1])]:
        with forms[name]():
            fn(make_state())
            ms = []
            for _ in range(reps):
                state = make_state()
                ms.append(_median_event_ms(torch, lambda: fn(state), 1))  # noqa: B023
            times[name].append(sorted(ms)[reps // 2])
    return times


def determinism_turns(torch, kept):
    """Phase 39(c): what the repairs replaced, and the by-design step's
    deterministic form. The port's earlier ECE (``scatter_add``) 20 times
    on one input and its CNN3D step (cuDNN's backward-data kernel) twice,
    to show the fault; the unfrozen fine-tune step under cuDNN's
    deterministic algorithms twice. Then each against the current form in
    turns (``forms_in_turns``): ECE and the bootstrap's six metrics at
    ``BOOT_SHAPE``, the CNN3D step, the unfrozen fine-tune step. ->
    record."""
    from pd_fusion_torch.analysis.sweep_checks import BOOT_SHAPE, bootstrap_inputs
    from pd_fusion_torch.nn import cnn3d
    from pd_fusion_torch.ops import metrics
    from pd_fusion_torch.utils import determinism_checks as dc

    y, p = (t.to(DEV) for t in bootstrap_inputs(*BOOT_SHAPE))
    earlier_ece = [dc.scatter_ece(y, p).cpu().numpy() for _ in range(20)]
    rec = {"scatter_ece_distinct_of_20": len({e.tobytes() for e in earlier_ece}),
           "scatter_ece_gap": max(dc.gap(earlier_ece[0], e) for e in earlier_ece)}

    def cudnn_data_grad(g, w):
        shape = (g.shape[0], w.shape[1], *g.shape[2:])
        return torch.nn.grad.conv3d_input(shape, w, g, padding=1)

    forms = {
        "ece": {"fixed_order": contextlib.nullcontext,
                "scatter_add": lambda: patched(metrics, "expected_calibration_error",
                                               dc.scatter_ece)},
        "cnn3d_train_step": {"forward_conv_data_grad": contextlib.nullcontext,
                             "cudnn_backward_data": lambda: patched(
                                 cnn3d, "_conv3x3_data_grad", cudnn_data_grad)},
        "ft_step_unfrozen": {"cudnn_default": contextlib.nullcontext,
                             "cudnn_deterministic": lambda: deterministic_cudnn(torch)},
    }
    with forms["cnn3d_train_step"]["cudnn_backward_data"]():
        twice = dc.run_twice(kept["cnn3d_train_step"].fn, kept["cnn3d_train_step"].make_state)
    rec["cnn3d_cudnn_backward_data_twice"] = max(g for _, g in twice.values())
    with deterministic_cudnn(torch):
        twice = dc.run_twice(kept["ft_step_unfrozen"].fn, kept["ft_step_unfrozen"].make_state)
    rec["ft_deterministic_equal_twice"] = all(eq for eq, _ in twice.values())
    print(f"phase 39(c) the faults: the earlier ECE (scatter_add) at {list(BOOT_SHAPE)}, 20 calls "
          f"on one input: {rec['scatter_ece_distinct_of_20']} different results, largest gap "
          f"{rec['scatter_ece_gap']:.3e}; the CNN3D step through cuDNN's backward-data kernel "
          f"twice: gap {rec['cnn3d_cudnn_backward_data_twice']:.3e}; the unfrozen fine-tune step "
          f"under cuDNN's deterministic algorithms: equal twice "
          f"{rec['ft_deterministic_equal_twice']}")

    calls = {"ece": (lambda _: metrics.expected_calibration_error(y, p), lambda: None),
             "bootstrap_metrics": (lambda _: metrics.binary_metrics(y, p), lambda: None),
             "cnn3d_train_step": (kept["cnn3d_train_step"].fn,
                                  kept["cnn3d_train_step"].make_state),
             "ft_step_unfrozen": (kept["ft_step_unfrozen"].fn,
                                  kept["ft_step_unfrozen"].make_state)}
    warm_clocks(torch)
    for name, (fn, make_state) in calls.items():
        arms = forms["ece" if name == "bootstrap_metrics" else name]
        # a fine-tune step takes 0.7 s; the CNN3D step is host-bound, its
        # blocks spread by +-20%, so it takes the most blocks
        reps, rounds = {"ft_step_unfrozen": (5, 2), "cnn3d_train_step": (10, 16)}.get(name, (10, 8))
        times = forms_in_turns(torch, arms, fn, make_state, reps, rounds)
        (a, ta), (b, tb) = times.items()
        ma, mb = (statistics.median(t) for t in (ta, tb))
        rec[f"{name}_ms"] = times
        rec[f"{name}_median_ms"] = {a: ma, b: mb}
        rec[f"{name}_ratio"] = mb / ma
        print(f"phase 39(c) {name} in turns ({rounds} blocks of {reps} calls each form, "
              f"alternated; each block's median between CUDA events): {a} "
              f"{[round(t, 3) for t in ta]} ms, {b} {[round(t, 3) for t in tb]} ms; medians "
              f"{ma:.3f} and {mb:.3f} ms, {b}/{a} {mb / ma:.4f}")
    return rec


def dir_artifacts(yaml, np, out: Path) -> dict:
    """What a run or a build leaves in ``out``: every ``results*.yaml``, the
    probabilities of every fold CSV, every array of every ``.npz`` and every
    column of every ``.parquet``. -> {file: parsed}."""
    import pandas as pd

    arts = {p.name: yaml.safe_load(p.read_text()) for p in sorted(out.glob("results*.yaml"))}
    arts.update({p.name: pd.read_csv(p)["y_prob"].to_numpy()
                 for p in sorted(out.glob("preds_fold_*.csv"))})
    for p in sorted(out.glob("*.npz")):
        with np.load(p, allow_pickle=True) as z:
            arts[p.name] = {k: z[k] for k in z.files}
    arts.update({p.name: {c: v.to_numpy() for c, v in pd.read_parquet(p).items()}
                 for p in sorted(out.glob("*.parquet"))})
    if not arts:
        raise RuntimeError(f"{out} holds no results, fold CSVs, .npz or .parquet")
    return arts


def rerun_specs(yaml, np, tmp: Path, manifest: Path, bench_ref):
    """Phase 39(b)'s runs: the bench CV frame (phase 7), the MIL CV on phase
    16's bags (phase 17), the MIL bag build (phase 16) and the CNN3D build
    (phase 25), each with its first run's artifacts."""
    det = tmp / "determinism"
    mil_cfg = yaml.safe_load(MIL_DATA.read_text())["resnet2d_config"]
    cnn_cfg = simple_data_config(yaml)["cnn_config"]
    bench_args = bench_ref["args"][:-1] + [str(det / "bench_cv")]
    return [
        {"name": "bench_cv", "module": "pd_fusion_torch.cli", "argv": bench_args,
         "out": det / "bench_cv", "ref": bench_ref["artifacts"], "expect_k1": False,
         "first": "phase 7", "what": "python -m pd_fusion_torch.cli " + " ".join(bench_args[:-2])},
        {"name": "mil_cv", "module": "pd_fusion_torch.cli",
         "argv": ["run", "--config", str(tmp / "mil_built.yaml"), "--output-dir",
                  str(det / "mil_cv")],
         "out": det / "mil_cv", "ref": dir_artifacts(yaml, np, tmp / "mil_built_run"),
         "expect_k1": True, "first": "phase 17",
         "what": "python -m pd_fusion_torch.cli run --config <phase 17's config>"},
        {"name": "mil_bag_build", "module": "pd_fusion_torch.scripts.build_resnet2d_mil_embeddings",
         "argv": script_argv(mil_cfg, manifest, det / "bags"), "out": det / "bags",
         "ref": dir_artifacts(yaml, np, tmp / "embeddings_resnet2d"), "expect_k1": False,
         "first": "phase 16",
         "what": "python -m pd_fusion_torch.scripts.build_resnet2d_mil_embeddings"},
        {"name": "cnn3d_build", "module": "pd_fusion_torch.scripts.build_cnn3d_embeddings",
         "argv": cnn3d_argv(cnn_cfg, manifest, det / "cnn3d"), "out": det / "cnn3d",
         "ref": dir_artifacts(yaml, np, tmp / "cnn3d_cache"), "expect_k1": False,
         "first": "phase 25", "what": "python -m pd_fusion_torch.scripts.build_cnn3d_embeddings"},
    ]


def determinism_child(spec_path) -> int:
    """Phase 39(b)'s child (``chip_smoke.py --determinism-child SPEC``): each
    of ``spec["runs"]`` through its module's ``main(argv)`` in this fresh
    process, K1's counts zeroed before each; its wall and K1's counts
    written to ``spec["out"]``."""
    import importlib

    import torch

    from pd_fusion_torch.ops import attention_pool as ap
    from pd_fusion_torch.utils.device import get_device

    spec = json.loads(Path(spec_path).read_text())
    get_device()  # full-f32 matmuls on the card, as in the smoke's own process
    rec = {}
    for run in spec["runs"]:
        main = importlib.import_module(run["module"]).main
        ap.reset_launch_counts()
        t0 = time.perf_counter()
        main(run["argv"])
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        rec[run["name"]] = {"wall_s": time.perf_counter() - t0, "k1": dict(ap.launch_counts)}
    Path(spec["out"]).write_text(json.dumps(rec))
    return 0


def determinism_rerun(np, yaml, tmp: Path, runs):
    """Phase 39(b): ``runs`` ({name, module, argv, out, ref, what}) again in
    one fresh child (``determinism_child``, killed after
    ``DIST_CHILD_TIMEOUT_S``), each one's artifacts in ``out`` held bit for
    bit against ``ref`` (the first run's, read by ``dir_artifacts``).
    Raises, after printing every run's line, when one differs. ->
    (records, {name: K1 launches})."""
    import os

    from pd_fusion_torch.utils import determinism_checks as dc

    spec = {"runs": [{k: r[k] for k in ("name", "module", "argv")} for r in runs],
            "out": str(tmp / "determinism_child.json")}
    (tmp / "determinism_child_spec.json").write_text(json.dumps(spec))
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--determinism-child",
         str(tmp / "determinism_child_spec.json")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    wall, _, _ = finish_torchrun(proc, "the determinism child")
    child = json.loads(Path(spec["out"]).read_text())
    rows = []
    for r in runs:
        again = dir_artifacts(yaml, np, r["out"])
        if not set(again) <= set(r["ref"]):  # the first run's directory may hold more
            raise RuntimeError(f"phase 39(b) {r['name']} wrote {sorted(again)}, the first run "
                               f"{sorted(r['ref'])}")
        twice = dc.compare({k: r["ref"][k] for k in again}, again)
        k1 = child[r["name"]]["k1"]
        if DEV == "cuda" and (k1["plain"] != 0 or (k1["kernel"] > 0) != r["expect_k1"]):
            raise RuntimeError(f"phase 39(b) {r['name']}: K1 launches {k1}")
        rows.append({"name": r["name"], "source": f"chip_smoke.py --determinism-child: {r['what']}",
                     "width": f"a fresh process against {r['first']}",
                     "equal": all(eq for eq, _ in twice.values()),
                     "gap": max((g for _, g in twice.values()), default=0.0),
                     "unequal_outputs": [k for k, (eq, _) in twice.items() if not eq],
                     "flagged": "not measured", "deterministic": True, "note": "",
                     "two_runs_s": child[r["name"]]["wall_s"]})
        print_determinism(rows[-1])
    print(f"phase 39(b) child: {wall:.3f} s with the process's start; runs "
          f"{json.dumps({k: round(v['wall_s'], 3) for k, v in child.items()})} s")
    failed = dc.failures(rows)
    if failed:
        raise RuntimeError("a fresh process's run differs from the first: " + "; ".join(failed))
    return rows, {k: v["k1"] for k, v in child.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--compare-with", type=Path, default=None,
                        help="another attention_pool.cu with K1's first C interface, timed "
                             "against K1 in turns")
    parser.add_argument("--dist-child", type=Path, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--determinism-child", type=Path, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.dist_child is not None:  # phase 37's torchrun child (dist_child)
        return dist_child(args.dist_child)
    if args.determinism_child is not None:  # phase 39's fresh child (determinism_child)
        return determinism_child(args.determinism_child)
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
            if k == 5:  # phases 37(c) and 39(b) hold their runs against this one
                bench_ref = {"cv5": bench_frame_results(yaml, np, tmp / name, 5),
                             "cv5_parallel_cv_s": cv["parallel_cv_s"],
                             "artifacts": dir_artifacts(yaml, np, tmp / name), "args": cv["args"]}
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

    # phases 14-19: the imaging embed path, then the MIL CV on its bags;
    # phases 20-22: the MIL fine-tune on the same volumes; the volumes and
    # bags stay until phase 31, phase 30's tables until phase 34
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_embed_"))
    tmp_ppmi = Path(tempfile.mkdtemp(prefix="chip_smoke_ppmi_"))
    try:
        embed_paths, embed_programs, built_launches, manifest = run_embed_path(
            torch, np, yaml, ap, cli, tmp)
        ft_paths, ft_programs, ft_launches = run_ft_path(torch, np, yaml, ap, cli, tmp, manifest)
        # phases 23-27: the ds001907 volume-feature path on the same volumes;
        # a dev dataset
        vol_paths, vol_programs, vol_launches = run_volume_path(torch, np, yaml, ap, cli, tmp,
                                                                manifest)
        paths += embed_paths + ft_paths + vol_paths
        programs.update(embed_programs, **ft_programs, **vol_programs)

        # phases 28-30: download-dev; the suites' device programs card vs
        # CPU; the PPMI study-data path
        t_new = time.perf_counter()
        dl_path, dl_launches = run_download_dev(ap, cli, tmp_ppmi)
        paths.append(dl_path)
        checks_rec = run_tabular_checks(torch)
        study_paths, study_progs, study_launches = run_study_path(torch, np, yaml, ap, tmp_ppmi)
        print(f"phases 28-30: {time.perf_counter() - t_new:.3f} s")
        paths += study_paths
        paths.append({"name": "ppmi_card_vs_cpu_checks", **checks_rec})
        programs.update(study_progs)
        vol_launches.update(study_launches, download_dev=dl_launches)

        # phase 31: the fused MIL sweep on phase 16's bags
        t_new = time.perf_counter()
        mil_sweep_path, mil_sweep_launches = run_mil_sweep(yaml, ap, tmp, manifest)
        paths.append(mil_sweep_path)
        # phase 32: the fused tabular sweep, its sequential twin in turns, the
        # sweep's analysis scripts and the bootstrap program
        sweep_tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sweep_"))
        try:
            sweep_paths, sweep_progs, sweep_launches = run_sweep_tier(torch, np, yaml, ap,
                                                                       sweep_tmp)
        finally:
            shutil.rmtree(sweep_tmp, ignore_errors=True)
        paths += sweep_paths
        programs.update(sweep_progs)
        vol_launches.update(sweep_launches)
        # phases 33-34: the stress test and the imaging upgrade on phase 30's tables
        processed = tmp_ppmi / "ppmi" / "processed"
        stress_path, stress_progs = run_stress(torch, np, ap, processed, tmp_ppmi, vol_launches)
        paths.append(stress_path)
        programs.update(stress_progs)
        imaging_paths, imaging_progs = run_imaging(torch, np, yaml, ap, processed, tmp_ppmi,
                                                   vol_launches)
        paths += imaging_paths
        programs.update(imaging_progs)
        if "sklearn" in sys.modules:
            raise RuntimeError("the sweep tier or the PPMI analyses imported scikit-learn")

        # phase 35: both submitters' dry runs
        ap.reset_launch_counts()
        paths.append(run_submitters_dry(tmp_ppmi / "submit"))
        _zero_k1(ap, vol_launches, "submitters_dry_run")
        print(f"phases 31-35: {time.perf_counter() - t_new:.3f} s")

        # phases 36-37: the multi-device tier on this one card, in child
        # processes under torchrun: the backend rule, NCCL at world 1, the
        # dry run at world 2 over gloo, the MIL bag build over phase 14's
        # volumes at world 2, the bench CV frame at world 2 against phase
        # 7's in-process run
        t_new = time.perf_counter()
        torch.cuda.empty_cache()
        bench_ref["bag_wall_s"] = next(p["wall_s"] for p in paths if p["name"] == "embed_mil_bags")
        nccl_rec = run_backend_rule_and_nccl(torch)
        dist_rec, dist_launches = run_dist_tier(torch, np, yaml, tmp, manifest, bench_ref, card)
        paths.append({**dist_rec, "nccl_world1": nccl_rec})
        print(f"phases 36-37: {time.perf_counter() - t_new:.3f} s")

        # phase 39: every device program twice on the card; the bench CV
        # frame, the MIL CV on phase 16's bags, the bag build and the CNN3D
        # build again in a fresh process, against phases 7, 17, 16 and 25
        t_new = time.perf_counter()
        torch.cuda.empty_cache()
        kept = {}
        det_rows, det_launches = determinism_programs(torch, ap, kept=kept)
        child_rows, child_k1 = determinism_rerun(
            np, yaml, tmp, rerun_specs(yaml, np, tmp, manifest, bench_ref))
        turns = determinism_turns(torch, kept)
        del kept
        paths.append({"name": "determinism", "programs": det_rows, "fresh_process": child_rows,
                      "turns": turns})
        print(f"phase 39: {time.perf_counter() - t_new:.3f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(tmp_ppmi, ignore_errors=True)

    # phase 38: the record (times at the training step's shape, and at B=80)
    print(json.dumps({"programs": [
        {"name": name, **{k: v for k, v in rec.items() if k != "prof"}}
        for name, rec in programs.items()]}))
    print(json.dumps({"paths": paths}))
    print(json.dumps({"kernels": [{
        "name": "attention_pool",
        "route": "cuda",
        "source": "src/pd_fusion_torch/csrc/attention_pool.cu",
        "replaces": "src/pd_fusion/ops/pallas_mil.py:26",
        "launches": res["launches"] + built_launches + ft_launches + mil_sweep_launches
        + dist_launches + det_launches + child_k1["mil_cv"]["kernel"]
        + sum(k1["kernel"] for k1 in vol_launches.values()),
        "launches_by_path": {"mil_cv_synthetic_bags": res["launches"],
                             "mil_cv_built_bags": built_launches, "mil_ft_cv": ft_launches,
                             "mil_fused_sweep": mil_sweep_launches,
                             "mil_ft_data_parallel": dist_launches,
                             "determinism_programs": det_launches,
                             "determinism_child_mil_cv": child_k1["mil_cv"]["kernel"],
                             **{name: k1["kernel"] for name, k1 in vol_launches.items()}},
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
