"""Checks of ``ops/normal_draw.py`` on a device, shared by the tests
(``tests/test_torch_port_normal_draw.py``) and ``chip_smoke.py``'s
phase 3(c): K3 (or, on the CPU, its plain version) against numpy's own
draw, bit for bit, with the generator's state and next draws after it;
K3's consumed count against the plain version's; a budget that runs short;
the fine-tune's preparation on the device against the same on the CPU;
K3's time between CUDA events."""
import math
from unittest import mock

import numpy as np
import torch

from pd_fusion_torch.ops import normal_draw as nd

# the fine-tune's noise (B=4 bags, L=64 slices of 160^2), odd sizes, a
# draw just over one tile of positions and draws of a few values
SHAPES = [(4, 64, 160, 160), (3, 61, 157, 163), (4097,), (7,), (1,)]
STDS = (0.01, 1.0)
NOISE_SHAPE = (4, 64, 160, 160)


def generator(seed: int, call: int = 0) -> np.random.Generator:
    """A generator as the benchmark seeds one: ``SeedSequence([seed, call])``."""
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence([seed, call])))


def host(values) -> np.ndarray:
    return values.cpu().numpy() if isinstance(values, torch.Tensor) else np.asarray(values)


def next_draws(rng):
    """A uniform, a normal and two 32-bit integers (the second may come
    from a buffered half)."""
    return (rng.uniform(), rng.normal(), int(rng.integers(0, 2**32, dtype=np.uint32)),
            int(rng.integers(0, 1000, dtype=np.uint32)))


def _bits_equal(got, want, what) -> float:
    """Raises unless ``got`` is ``want`` bit for bit. -> the largest
    absolute difference, measured (0.0 when equal)."""
    if got.shape != want.shape or got.dtype != np.float32:
        raise RuntimeError(f"{what}: got {got.dtype} {got.shape}, want float32 {want.shape}")
    diff = np.flatnonzero(got.view(np.uint32).ravel() != want.view(np.uint32).ravel())
    if diff.size:
        i = int(diff[0])
        raise RuntimeError(f"{what}: {diff.size} values differ, the first at {i}: "
                           f"{got.ravel()[i]!r} against numpy's {want.ravel()[i]!r}")
    return float(np.max(np.abs(got - want), initial=0.0))


def draw(device, rng, scale: float, shape):
    """The draw checked on ``device``: K3 through ``normal`` on the card,
    the plain version (``normal_plain``) on the CPU, where ``normal`` is
    numpy's own draw."""
    if torch.device(device).type == "cpu":
        return nd.normal_plain(rng, scale, shape)
    return nd.normal(rng, scale, shape, device)


def check_draw(device, seed: int, shape, scale: float, buffered: bool = False) -> float:
    """One draw on ``device`` (``draw``) against ``rng.normal(0, scale,
    shape)`` as float32, bit for bit, then the generator's state and next
    draws; ``buffered``: a 32-bit draw first, so that the generator holds a
    buffered half across the draw. -> the largest absolute difference from
    numpy's values, measured."""
    ref, rng = generator(seed), generator(seed)
    if buffered:
        for g in (ref, rng):
            g.integers(0, 2**32, dtype=np.uint32)
        if not rng.bit_generator.state["has_uint32"]:
            raise RuntimeError("the 32-bit draw left no buffered half")
    want = ref.normal(0.0, scale, shape).astype(np.float32)
    got = host(draw(device, rng, scale, shape))
    what = f"seed {seed} {shape} std {scale}"
    err = _bits_equal(got, want, what)
    if rng.bit_generator.state != ref.bit_generator.state:
        raise RuntimeError(f"{what}: the generator's state differs after the draw")
    if next_draws(rng) != next_draws(ref):
        raise RuntimeError(f"{what}: the next draws differ")
    return err


def check_consumed(device, seed: int, shape, scale: float, budget=None) -> int:
    """K3's one draw at ``budget`` (by default the first) against the plain
    version's: the same values and the same count of outputs consumed.
    -> the count."""
    st = generator(seed).bit_generator.state["state"]
    n = math.prod(shape)
    budget = budget or nd.first_budget(n)
    card = nd.launch_kernel(st["state"], st["inc"], n, 0.0, scale, budget, device)
    plain = nd.draw_plain(st["state"], st["inc"], n, 0.0, scale, budget)
    if (card is None) != (plain.values is None):
        raise RuntimeError(f"seed {seed} {shape} budget {budget}: short on one side only")
    if card is None:
        return 0
    _bits_equal(host(card[0]), plain.values, f"seed {seed} {shape} (plain version)")
    if card[1] != plain.consumed:
        raise RuntimeError(f"seed {seed} {shape}: K3 consumed {card[1]}, the plain version "
                           f"{plain.consumed}")
    return card[1]


def check_short_budget(device, seed: int, shape=NOISE_SHAPE, scale: float = 0.01):
    """A budget of ``n`` positions yields under ``n`` values (some attempt
    among them is longer or yields nothing), and ``normal`` drawn from such
    a first budget draws again and gives numpy's bits."""
    st = generator(seed).bit_generator.state["state"]
    n = math.prod(shape)
    if torch.device(device).type == "cuda":
        short = nd.launch_kernel(st["state"], st["inc"], n, 0.0, scale, n, device) is None
    else:
        short = nd.draw_plain(st["state"], st["inc"], n, 0.0, scale, n).values is None
    if not short:
        raise RuntimeError(f"seed {seed}: a budget of n positions did not run short")
    with mock.patch.object(nd, "first_budget", lambda m: m):
        check_draw(device, seed, shape, scale)


def preparation(model, bags, y, seed: int):
    """The host arrays (noise on the host) of one epoch of ``train`` and one
    TTA ``predict_proba`` of ``model``, and its generators' states after."""
    out, rng = [], generator(seed, 0)
    steps = model._epoch_steps(bags, y, rng)
    next(steps)
    out += [{k: host(v) for k, v in item.items()} for item in steps]
    chunks = [list(range(i, min(len(bags), i + model.bag_batch_size)))
              for i in range(0, len(bags), model.bag_batch_size)]
    rng_p = generator(seed, 1)
    passes = model._predict_passes(bags, chunks, max(model.tta_inference, 1), rng_p)
    next(passes)
    for padded, draw in passes:
        out.append({"padded": None if padded is None else [host(a) for a in padded],
                    "draw": None if draw is None else [host(a) for a in draw]})
    return out, (rng.bit_generator.state, rng_p.bit_generator.state)


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def check_model_path(device, seed: int, n_bags=6, L=64, hw=160):
    """The fine-tune's ``_epoch_steps`` and ``_predict_passes`` on
    ``device`` against the same on the CPU: every array equal byte for
    byte (the noise among them), and the generators' states after.
    -> the draws compared."""
    from pd_fusion_torch.models.mil_attention_finetune import MilAttentionFineTuneModel

    params = {"backbone": "resnet18", "pretrained": False, "slice_count": L,
              "target_shape": [hw, hw, hw], "input_size": 32, "batch_size": 4, "epochs": 1,
              "hidden_dim": 16, "attn_dim": 8, "train_aug": True, "balanced_batches": True,
              "tta_inference": 2, "noise_std": 0.01}
    g = np.random.default_rng(seed)
    bags = [g.random((L, hw, hw), dtype=np.float32) for _ in range(n_bags)]
    y = (np.arange(n_bags) % 2).astype(np.float32)
    got = preparation(MilAttentionFineTuneModel(params, device=device), bags, y, seed)
    want = preparation(MilAttentionFineTuneModel(params, device="cpu"), bags, y, seed)
    if not _same(got[0], want[0]):
        raise RuntimeError(f"seed {seed}: the prepared arrays differ from the CPU's")
    if got[1] != want[1]:
        raise RuntimeError(f"seed {seed}: the generators' states differ from the CPU's")
    return sum(1 for item in got[0] if "noise" in item or item.get("draw") is not None)


def time_kernel(device, shape=NOISE_SHAPE, scale: float = 0.01, reps: int = 20) -> dict:
    """K3's five launches at ``shape`` between CUDA events on its stream
    (median of ``reps``, after a warm-up), and the whole ``normal`` call
    (the count's read-back and the generator's jump included) on the
    host's clock. -> milliseconds."""
    import statistics
    import time

    st = generator(1).bit_generator.state["state"]
    n = math.prod(shape)
    budget = nd.first_budget(n)
    stream = nd.draw_stream(device)
    times, calls = [], []
    with torch.cuda.device(stream.device), torch.cuda.stream(stream):
        bufs = nd.scratch(n, budget, stream.device)
        for k in range(reps + 3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            nd.launch(bufs, st["state"], st["inc"], n, 0.0, scale, budget, stream)
            end.record(stream)
            stream.synchronize()
            if k >= 3:
                times.append(start.elapsed_time(end))
    rng = generator(2)
    for k in range(reps + 3):
        t0 = time.perf_counter()
        nd.normal(rng, scale, shape, device)
        if k >= 3:
            calls.append((time.perf_counter() - t0) * 1e3)
    return {"kernel_ms": statistics.median(times), "call_ms": statistics.median(calls)}
