"""K1's launch arithmetic (``ops/attention_pool.py::launch_config``) held to
the H100's limits on the CPU: the CUDA source takes these values as given,
so what the card would refuse or what a wrong cover would miss shows here.

Shapes: every (B, L) of the repo's MIL configs (L=48 at B=16 and the
evaluation width 80; the fine-tune's B=4, L=64; the 3-axis bags' L=72 at
B=8 and 16) and the tails L=1, 13, 97 and 4096, each at H in {1, 97, 100,
256, 2048}.
"""
import itertools

import pytest
import torch

from pd_fusion_torch.ops import attention_pool as ap
from pd_fusion_torch.ops import attention_pool_checks as checks

BAGS = [(16, 48), (80, 48), (4, 64), (16, 72), (8, 72), (3, 1), (5, 13), (2, 97), (2, 4096)]
WIDTHS = [1, 97, 100, 256, 2048]
SHAPES = [(B, L, H) for (B, L), H in itertools.product(BAGS, WIDTHS)]


def _spans(n, step, count):
    return [range(i * step, min(n, (i + 1) * step)) for i in range(count)]


@pytest.mark.parametrize("B,L,H", SHAPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_launch_fits_the_card(B, L, H, aligned):
    cfg = ap.launch_config(B, L, H, aligned)
    assert cfg.smem_bytes <= ap.SMEM_LIMIT
    assert 32 <= cfg.block <= ap.THREADS_LIMIT and cfg.block % 32 == 0
    # one block per bag and column chunk: no cluster is launched
    assert cfg.grid[0] == B and 1 <= cfg.grid[1] <= ap.GRID_Y_LIMIT
    # each warp takes an equal share of the chunk's column vectors, at most
    # one for each of its lanes, in a power of two
    vectors = cfg.chunk // (1 if cfg.path == "scalar" else 4)
    lanes_per_row, rest = divmod(vectors, cfg.block // 32)
    assert rest == 0 and 1 <= lanes_per_row <= 32 and lanes_per_row & (lanes_per_row - 1) == 0
    assert cfg.smem_bytes >= cfg.n_buffers * cfg.stage_rows * cfg.chunk * 4


@pytest.mark.parametrize("B,L,H", SHAPES)
def test_blocks_cover_every_column_and_row_exactly_once(B, L, H):
    for aligned in (True, False):
        cfg = ap.launch_config(B, L, H, aligned)
        cols = [c for span in _spans(H, cfg.chunk, cfg.grid[1]) for c in span]
        assert sorted(cols) == list(range(H))
        assert all(len(span) for span in _spans(H, cfg.chunk, cfg.grid[1]))
        # one buffer holds the bag's rows whole; two take them in stages
        n_stages = -(-L // cfg.stage_rows)
        stages = _spans(L, cfg.stage_rows, n_stages)
        assert sorted(r for span in stages for r in span) == list(range(L))
        assert all(len(span) for span in stages)
        assert cfg.n_buffers in (1, 2)
        if cfg.n_buffers == 1:
            assert cfg.stage_rows == L
        else:
            assert 1 <= cfg.stage_rows < L


@pytest.mark.parametrize("B,L,H", SHAPES)
def test_scalar_path_exactly_when_shape_or_alignment_demands(B, L, H):
    for aligned in (True, False):
        cfg = ap.launch_config(B, L, H, aligned)
        assert (cfg.path == "scalar") == (H % 4 != 0 or not aligned)
        if cfg.path != "scalar":
            assert cfg.chunk % 4 == 0


def test_alignment_is_read_from_the_pointer():
    B, L, H = 2, 5, 8
    _, _, h = checks.pool_inputs(B, L, H, (), seed=0, device="cpu")
    _, _, h_off = checks.pool_inputs(B, L, H, (), seed=0, device="cpu", h_offset=1)
    assert h_off.is_contiguous() and h_off.shape == (B, L, H)
    assert ap.is_aligned(h) and h_off.data_ptr() % 16 == 4 and not ap.is_aligned(h_off)
    assert ap.launch_config(B, L, H, ap.is_aligned(h_off)).path == "scalar"
    torch.testing.assert_close(h_off, h, atol=0, rtol=0)
    # on the CPU both take the plain version, with the same result
    torch.testing.assert_close(ap.attention_pool_forward(*checks.pool_inputs(
        B, L, H, (1,), seed=3, device="cpu", h_offset=1)), ap.attention_pool_forward(
        *checks.pool_inputs(B, L, H, (1,), seed=3, device="cpu")), atol=0, rtol=0)


def test_long_bags_are_staged_through_two_buffers():
    cfg = ap.launch_config(2, 4096, 256, True)
    assert cfg.n_buffers == 2 and cfg.grid == (2, 256 // cfg.chunk)
    assert ap.launch_config(16, 48, 256, True).n_buffers == 1


@pytest.mark.parametrize("B,L,chunk", [(80, 48, 64), (16, 48, 64), (8, 72, 32), (4, 64, 16),
                                       (1, 48, 16)])
def test_chunks_narrow_until_the_grid_fills(B, L, chunk):
    cfg = ap.launch_config(B, L, 256, True)
    assert cfg.chunk == chunk
    assert cfg.grid[0] * cfg.grid[1] >= ap.MIN_BLOCKS or cfg.chunk == ap.MIN_CHUNK


def test_launch_config_is_computed_once_per_shape():
    assert ap.launch_config(16, 48, 256, True) is ap.launch_config(16, 48, 256, True)


@pytest.mark.parametrize("B,L,H", [(0, 48, 256), (16, 0, 256), (16, 48, 0)])
def test_launch_config_rejects_an_empty_shape(B, L, H):
    with pytest.raises(ValueError):
        ap.launch_config(B, L, H, True)
