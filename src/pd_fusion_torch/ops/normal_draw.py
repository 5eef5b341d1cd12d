"""numpy's normal draw, bit for bit, made on the device: kernel K3
(``csrc/normal_draw.cu``) on the card, numpy's own draw on the CPU, and
K3's plain version in numpy, which the checks hold K3 to.

``normal(rng, scale, shape, device)`` returns what
``rng.normal(0.0, scale, shape).astype(np.float32)`` returns, and leaves
``rng`` (a ``Generator`` over ``PCG64``) in the state that draw leaves it
in. numpy draws each value with ``random_standard_normal`` (its
``distributions.c``), a ziggurat over 64-bit outputs of ``PCG64``:

- ``PCG64`` steps ``s <- s * PCG_MULT + inc (mod 2^128)`` and outputs
  ``rotr64(hi(s) ^ lo(s), s >> 122)`` of the new state;
- an attempt takes one output ``r``: ``idx = r & 0xff``, the sign is bit 8,
  ``rabs`` the next 52 bits, ``x = +-rabs * wi[idx]``; it yields ``x`` if
  ``rabs < ki[idx]``; else, for ``idx > 0`` (the wedge), it takes one more
  output ``u`` and yields ``x`` if ``(fi[idx-1] - fi[idx]) * u + fi[idx] <
  exp(-0.5 * x * x)``, else it yields nothing; for ``idx == 0`` (the tail)
  it takes outputs in pairs until ``2 * yy > xx * xx`` (``xx = -inv_r *
  log1p(-u1)``, ``yy = -log1p(-u2)``) and yields ``+-(r + xx)``;
- attempts follow one another until ``n`` values are yielded, each value
  ``float32(loc + scale * x)``, rounded once from the double.

Each position ``p`` of the output stream is the start of one possible
attempt, whose length and value depend on the outputs from ``p`` on alone.
So K3 and its plain version compute every position's attempt in
parallel, then find which positions the chain of attempts starting at 0
passes through: a position the chain skips lies inside an earlier
attempt of the chain. Over
99% of attempts take one output, so the chain is the identity but for
short clusters. A position whose attempt takes more than one output is
*clear* when no earlier position's attempt reaches past it: the chain then
passes through it, and it starts a walk along the chain that marks the
positions its attempts cover, up to the next clear chain position.
Positions on the chain that yield are counted (an exclusive scan); the
first ``n`` give the values, and the end of the attempt that yields value
``n - 1`` is the number of outputs the draw consumed. The host then moves
the generator past them with the LCG's jump-ahead (``advance``), keeping
the buffered 32-bit value that numpy's draw leaves alone.

The outputs are counted against a budget of ``n + n / 20 + 4096``
positions (a draw consumes about 2.2% more outputs than values); a budget whose
chain yields fewer than ``n`` values is drawn again at twice the size,
which gives the same values, as the stream is fixed by the state.

On a CUDA device the draw is K3 on a stream of its own (high priority, so
it does not queue behind a step's kernels): five launches, then the
count is read back through a pinned buffer, synchronizing that stream
alone. A launch still waits on the host while another thread is inside a
pageable host-to-device copy that waits for its stream: CUDA holds the
launch until that copy is done (about 45 ms a step in a cell whose
device paces it), though the card runs K3 at once. The tensor is complete when ``normal`` returns; ``hand_over(t)``
records the caller's stream on it, so its memory is not reused while the
caller's kernels read it. On a CPU device ``normal`` is numpy's own draw,
which the plain version only repeats, more slowly. The plain version
(``draw_plain``, K3's passes in numpy; ``normal_plain``, its budget loop
and jump) is the reference the tests and ``normal_draw_checks.py`` hold
K3 to. Counters (``utils/profiling.py``): ``trainer:noise_on_card``,
draws made by K3, and ``trainer:noise_raw``, the outputs those draws
consumed. ``launch_counts`` counts K3's launches ("kernel") and calls of
the plain version ("plain").
"""
import ctypes
import functools
import math
import re
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from pd_fusion_torch.ops.attention_pool import build_library
from pd_fusion_torch.utils import profiling

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "normal_draw.cu"

PCG_MULT = 0x2360ED051FC65DA44385DF649FCCF645
MASK64 = (1 << 64) - 1
MASK128 = (1 << 128) - 1
ZIGGURAT_R = 3.6541528853610087963519472518  # numpy's ziggurat_nor_r
ZIGGURAT_INV_R = 0.27366123732975827203338247596  # ziggurat_nor_inv_r
U53 = 1.0 / 9007199254740992.0  # (output >> 11) * 2^-53: numpy's next_double

TILE = 4096  # positions a block of the counting kernels (csrc/normal_draw.cu::kTile)
LAUNCHES = 5  # kernels a draw
MAX_BUDGET = 2**31 - 2 * TILE  # the kernels index positions with 32-bit ints
COLUMNS = 1024  # the plain version's states, computed as [rows, COLUMNS]

launch_counts = {"kernel": 0, "plain": 0}
_lib = {}
_streams = {}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def first_budget(n: int) -> int:
    return n + n // 20 + 4096


# ---- the LCG on the host (Python ints) ------------------------------------
def jump(delta: int):
    """(mult, gsum) of ``delta`` LCG steps: ``s -> mult * s + inc * gsum``
    (mod 2^128), for every ``inc`` (numpy's ``pcg_advance_lcg_128`` with the
    increment factored out)."""
    mult, gsum, cur_mult, cur_g = 1, 0, PCG_MULT, 1
    while delta > 0:
        if delta & 1:
            mult = mult * cur_mult & MASK128
            gsum = (gsum * cur_mult + cur_g) & MASK128
        cur_g = (cur_mult + 1) * cur_g & MASK128
        cur_mult = cur_mult * cur_mult & MASK128
        delta >>= 1
    return mult, gsum


def advance(state: int, inc: int, delta: int) -> int:
    """The state ``delta`` outputs after ``state``, as ``PCG64.advance``."""
    mult, gsum = jump(delta)
    return (mult * state + inc * gsum) & MASK128


# ---- the plain version (numpy) ---------------------------------------------
@functools.lru_cache(maxsize=1)
def tables():
    """(ki uint64, wi float64, fi float64) [256]: the words of
    ``normal_draw.cu``'s tables (numpy's ``ki_double``, ``wi_double``,
    ``fi_double``; ``csrc/ziggurat_tables.py``)."""
    text = SOURCE.read_text()
    out = []
    for name in ("kKi", "kWiBits", "kFiBits"):
        body = re.search(name + r"\[256\] = \{([^}]*)\}", text).group(1)
        words = np.array([int(w, 16) for w in re.findall(r"0x([0-9a-f]{16})ull", body)],
                         np.uint64)
        if words.shape != (256,):
            raise ValueError(f"{SOURCE}: {name} has {words.size} words, want 256")
        out.append(words)
    return out[0], out[1].view(np.float64), out[2].view(np.float64)


def _split(values):
    """128-bit Python ints -> (low, high) uint64 words."""
    return (np.array([v & MASK64 for v in values], np.uint64),
            np.array([v >> 64 for v in values], np.uint64))


def _mulhi(a, b):
    """The high 64 bits of uint64 ``a * b``."""
    m32 = np.uint64(0xFFFFFFFF)
    a0, a1, b0, b1 = a & m32, a >> 32, b & m32, b >> 32
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> 32) + (p01 & m32) + (p10 & m32)
    return p11 + (p01 >> 32) + (p10 >> 32) + (mid >> 32)


@functools.lru_cache(maxsize=4)
def _column_jumps(columns: int):
    """(mult, gsum) of 0 .. columns - 1 steps, split into 64-bit words."""
    mult, gsum, m, g = [], [], 1, 0
    for _ in range(columns):
        mult.append(m)
        gsum.append(g)
        m, g = m * PCG_MULT & MASK128, (g * PCG_MULT + 1) & MASK128
    return _split(mult), gsum


def raw_outputs(state: int, inc: int, start: int, count: int) -> np.ndarray:
    """uint64 outputs ``start .. start + count - 1`` of the stream that
    follows ``state`` (output ``p`` is that of the state ``p + 1`` steps on)."""
    cols = max(1, min(COLUMNS, count))
    rows = -(-count // cols)
    (m_lo, m_hi), gsum = _column_jumps(cols)
    g_lo, g_hi = _split([inc * g & MASK128 for g in gsum])
    row_mult, row_g = jump(cols)
    starts, s = [], advance(state, inc, start + 1)
    for _ in range(rows):
        starts.append(s)
        s = (row_mult * s + inc * row_g) & MASK128
    r_lo, r_hi = _split(starts)
    r_lo, r_hi = r_lo[:, None], r_hi[:, None]
    with np.errstate(over="ignore"):
        lo = m_lo * r_lo
        hi = _mulhi(m_lo, r_lo) + m_lo * r_hi + m_hi * r_lo
        lo2 = lo + g_lo
        hi = hi + g_hi + (lo2 < lo).astype(np.uint64)
    x = hi ^ lo2
    rot = hi >> 58
    out = (x >> rot) | (x << ((np.uint64(64) - rot) & np.uint64(63)))
    return out.reshape(-1)[:count]


class PlainDraw(NamedTuple):
    values: Optional[np.ndarray]  # float32 [n], or None when the budget runs short
    consumed: int  # outputs the draw consumed (0 when short)
    tails: int  # attempts on the chain that went to the tail (idx == 0)
    wedge_restarts: int  # wedge attempts on the chain that yielded nothing
    covered: int  # longer attempts inside an earlier chain attempt's span


def _uniform(raw):
    return (raw >> np.uint64(11)).astype(np.float64) * U53


def draw_plain(state: int, inc: int, n: int, loc: float, scale: float, budget: int) -> PlainDraw:
    """The plain version of K3: ``n`` values from the stream after
    ``state``, counted against ``budget`` positions, by the kernel's
    passes in numpy."""
    launch_counts["plain"] += 1
    ki, wi, fi = tables()
    raws = raw_outputs(state, inc, 0, budget + 64)

    def raw_at(idx):
        nonlocal raws
        if idx.size and int(idx.max()) >= raws.size:
            more = int(idx.max()) + 64 - raws.size
            raws = np.concatenate([raws, raw_outputs(state, inc, raws.size, more)])
        return raws[idx]

    # pass 1: every position's attempt
    raw = raws[:budget]
    idx = (raw & np.uint64(0xFF)).astype(np.int64)
    r = raw >> np.uint64(8)
    rabs = (r >> np.uint64(1)) & np.uint64(0x000FFFFFFFFFFFFF)
    x = rabs.astype(np.float64) * wi[idx]
    x = np.where((r & np.uint64(1)) != 0, -x, x)
    longer = np.flatnonzero(rabs >= ki[idx])
    lens = np.ones(budget, np.int64)
    yields = np.ones(budget, bool)
    wedge = longer[idx[longer] != 0]
    if wedge.size:
        i = idx[wedge]
        u = _uniform(raw_at(wedge + 1))
        lhs = (fi[i - 1] - fi[i]) * u + fi[i]
        rhs = np.array([math.exp(v) for v in ((-0.5 * x[wedge]) * x[wedge]).tolist()])
        lens[wedge] = 2
        yields[wedge] = lhs < rhs
    tail = longer[idx[longer] == 0]
    active, k = tail, 0
    while active.size:
        u1 = _uniform(raw_at(active + 1 + 2 * k)).tolist()
        u2 = _uniform(raw_at(active + 2 + 2 * k)).tolist()
        xx = np.array([-ZIGGURAT_INV_R * math.log1p(-u) for u in u1])
        yy = np.array([-math.log1p(-u) for u in u2])
        done = yy + yy > xx * xx
        hit = active[done]
        sign = ((rabs[hit] >> np.uint64(8)) & np.uint64(1)) != 0
        x[hit] = np.where(sign, -(ZIGGURAT_R + xx[done]), ZIGGURAT_R + xx[done])
        lens[hit] = 3 + 2 * k
        active, k = active[~done], k + 1

    # pass 2: the chain; a walk from each clear longer attempt
    lam = int(lens.max())

    def clear(c):
        ok = np.ones(c.size, bool)
        for j in range(1, lam):
            q = c - j
            ok &= ~((q >= 0) & (lens[np.maximum(q, 0)] > j))
        return ok

    skip = np.zeros(budget, bool)
    c = longer[clear(longer)]
    while c.size:
        ln = lens[c]
        for j in range(1, lam):
            at = c[(j < ln) & (c + j < budget)] + j
            skip[at] = True
        c = c + ln
        c = c[c < budget]
        c = c[~clear(c)]

    # pass 3: the first n values on the chain
    on_chain = np.flatnonzero(yields & ~skip)
    if on_chain.size < n:
        return PlainDraw(None, 0, 0, 0, 0)
    end = on_chain[n - 1]
    consumed = int(end + lens[end])
    values = (loc + scale * x[on_chain[:n]]).astype(np.float32)
    seen = longer[longer < consumed]
    chain = seen[~skip[seen]]
    return PlainDraw(values, consumed, int(np.sum(idx[chain] == 0)),
                     int(np.sum((idx[chain] != 0) & ~yields[chain])), int(np.sum(skip[seen])))


# ---- K3 on the card ---------------------------------------------------------
def _library():
    if "lib" not in _lib:
        lib = ctypes.CDLL(str(build_library(SOURCE)))
        lib.normal_draw.argtypes = (
            [ctypes.c_uint64] * 4 + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_double] * 2
            + [ctypes.c_void_p] * 8)
        lib.normal_draw.restype = ctypes.c_int
        _lib["lib"] = lib
    return _lib["lib"]


def draw_stream(device) -> "torch.cuda.Stream":
    """K3's own stream on ``device`` (high priority)."""
    device = torch.device(device)
    key = device.index if device.index is not None else torch.cuda.current_device()
    if key not in _streams:
        _streams[key] = torch.cuda.Stream(device=key, priority=-1)
    return _streams[key]


def scratch(n: int, budget: int, device):
    """K3's output and scratch for ``n`` values at ``budget`` positions, in
    the C function's order: out, val, info, skip, tile_count, tile_off,
    meta."""
    tiles = -(-budget // TILE)
    return [torch.empty(n, dtype=torch.float32, device=device),
            torch.empty(tiles * TILE, dtype=torch.float32, device=device),
            torch.empty(tiles * TILE, dtype=torch.int16, device=device),
            torch.empty(tiles * TILE, dtype=torch.uint8, device=device),
            torch.empty(tiles, dtype=torch.int32, device=device),
            torch.empty(tiles, dtype=torch.int32, device=device),
            torch.empty(4, dtype=torch.int64, device=device)]


def launch(bufs, state: int, inc: int, n: int, loc: float, scale: float, budget: int, stream):
    """K3's five launches on ``stream`` into ``scratch``'s buffers."""
    err = _library().normal_draw(state & MASK64, state >> 64, inc & MASK64, inc >> 64, n, budget,
                                 loc, scale, *[b.data_ptr() for b in bufs], stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"normal_draw launch failed: CUDA error {err} (n {n}, budget {budget})")
    launch_counts["kernel"] += LAUNCHES


def launch_kernel(state: int, inc: int, n: int, loc: float, scale: float, budget: int, device):
    """One K3 draw on its stream, then the count read back -> (float32
    tensor [n], outputs consumed), or None when the budget runs short."""
    if not 0 < n <= budget <= MAX_BUDGET:
        raise ValueError(f"normal_draw: needs 0 < n <= budget <= {MAX_BUDGET}; got {n}, {budget}")
    stream = draw_stream(device)
    with torch.cuda.device(stream.device), torch.cuda.stream(stream):
        bufs = scratch(n, budget, stream.device)
        launch(bufs, state, inc, n, loc, scale, budget, stream)
        host = torch.empty(4, dtype=torch.int64, pin_memory=True)
        host.copy_(bufs[-1], non_blocking=True)
        stream.synchronize()
    _longest, total, consumed, error = host.tolist()
    if error:
        raise RuntimeError(f"normal_draw: a tail attempt ran past {2**15 - 1} outputs")
    if total < n:
        return None
    return bufs[0], consumed


def _drawn(rng: np.random.Generator, shape, draw):
    """``draw(state, inc, n, budget)`` -> (values, consumed) or None when
    short, from the first budget on, doubling it until the chain yields
    ``n`` values; then ``rng`` is jumped past what was consumed. ->
    (values, consumed)."""
    bg = rng.bit_generator
    st = bg.state
    if st["bit_generator"] != "PCG64":
        raise ValueError(f"normal_draw: needs a PCG64 generator, got {st['bit_generator']}")
    state, inc = st["state"]["state"], st["state"]["inc"]
    n = math.prod(shape)
    budget, drawn = first_budget(n), None
    while drawn is None:
        drawn = draw(state, inc, n, budget)
        budget *= 2
    st["state"]["state"] = advance(state, inc, drawn[1])
    bg.state = st  # has_uint32 and uinteger as they were
    return drawn


def normal(rng: np.random.Generator, scale: float, shape, device):
    """``rng.normal(0.0, scale, shape).astype(np.float32)``, bit for bit,
    drawn on ``device``: a CUDA tensor (K3) or, on the CPU, that numpy
    array itself. ``rng`` is left as numpy's draw leaves it."""
    device = torch.device(device)
    if device.type == "cpu":
        return rng.normal(0.0, scale, shape).astype(np.float32)
    if device.type != "cuda":
        raise ValueError(f"normal_draw: unsupported device {device}")
    if math.prod(shape) == 0:
        return torch.zeros(shape, device=device)
    values, consumed = _drawn(rng, shape, lambda state, inc, n, budget: launch_kernel(
        state, inc, n, 0.0, scale, budget, device))
    profiling.count("trainer:noise_on_card")
    profiling.count("trainer:noise_raw", consumed)
    return values.reshape(shape)


def normal_plain(rng: np.random.Generator, scale: float, shape) -> np.ndarray:
    """The plain version of ``normal`` on the card: ``draw_plain``'s values
    and its jump of ``rng``, as a numpy array."""
    if math.prod(shape) == 0:
        return np.zeros(shape, np.float32)

    def draw(state, inc, n, budget):
        plain = draw_plain(state, inc, n, 0.0, scale, budget)
        return None if plain.values is None else (plain.values, plain.consumed)

    return _drawn(rng, shape, draw)[0].reshape(shape)


def hand_over(t: torch.Tensor) -> torch.Tensor:
    """``t``, made on another stream, for use on the caller's current
    stream: its memory is held until that stream's work on it is done."""
    if t.is_cuda:
        t.record_stream(torch.cuda.current_stream(t.device))
    return t
