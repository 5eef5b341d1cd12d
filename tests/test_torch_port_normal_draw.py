"""numpy's normal draw made on the device (``pd_fusion_torch/ops/normal_draw.py``,
kernel K3 on the card, numpy's own draw on the CPU, and K3's plain version).

- On the CPU ``normal`` is numpy's own draw and runs no plain version.
- The plain version gives ``rng.normal(0, std, shape).astype(float32)`` bit
  for bit, for generators seeded as the benchmark seeds them, at 1, 7, 4097
  and the fine-tune's ``[4, 64, 160, 160]`` values and std 0.01 and 1.0, and
  leaves the generator where numpy's draw leaves it: its next uniform,
  normal and 32-bit draws are numpy's, with a buffered 32-bit half too.
- The compared draws take every rare path: a tail attempt, a wedge that
  yields nothing, a longer attempt inside an earlier one's span.
- The LCG's jump-ahead equals ``PCG64.advance``; the plain outputs equal
  ``random_raw``; the tables are those of the installed numpy.
- A budget that runs short draws again with the same bits; no noise, no
  draw.
- On a card (``cuda`` marker): K3 against numpy on 32 seeds and odd sizes,
  its consumed count against the plain version's, a short budget, the
  fine-tune's preparation against the CPU's, its launches and counters.

The module imports no JAX: ``python -m pytest tests/test_torch_port_normal_draw.py -q``.
"""
import math
import sys

import numpy as np
import pytest
import torch

from pd_fusion_torch.ops import normal_draw as nd
from pd_fusion_torch.ops import normal_draw_checks as ndc
from pd_fusion_torch.utils import profiling

sys.path.insert(0, str(nd.SOURCE.parent))
import ziggurat_tables  # noqa: E402

SEED = 2**31 + 11  # the benchmark's seeds are large
SMALL = [(1,), (7,), (4097,)]
FULL_SEEDS = (SEED, 3160000102)


@pytest.fixture(autouse=True)
def _counts():
    nd.reset_launch_counts()
    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("shape", [(0,), (7,), ndc.NOISE_SHAPE], ids=str)
def test_on_the_cpu_normal_is_numpys_own_draw(shape):
    rng, ref = ndc.generator(SEED), ndc.generator(SEED)
    got = nd.normal(rng, 0.01, shape, "cpu")
    want = ref.normal(0.0, 0.01, shape).astype(np.float32)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert rng.bit_generator.state == ref.bit_generator.state
    assert nd.launch_counts == {"kernel": 0, "plain": 0}


@pytest.mark.parametrize("std", ndc.STDS)
@pytest.mark.parametrize("shape", SMALL, ids=str)
@pytest.mark.parametrize("seed", [0, 1, 7, SEED])
def test_plain_version_is_numpys_draw_at_small_sizes(seed, shape, std):
    ndc.check_draw("cpu", seed, shape, std)


@pytest.mark.parametrize("std", ndc.STDS)
@pytest.mark.parametrize("seed", FULL_SEEDS)
def test_plain_version_is_numpys_draw_at_the_finetunes_noise(seed, std):
    ndc.check_draw("cpu", seed, ndc.NOISE_SHAPE, std)
    assert nd.launch_counts == {"kernel": 0, "plain": 1}


@pytest.mark.parametrize("shape", [(4097,), ndc.NOISE_SHAPE], ids=str)
def test_the_generator_afterwards_with_a_buffered_half(shape):
    ndc.check_draw("cpu", SEED, shape, 0.01, buffered=True)


def test_the_compared_draws_take_every_rare_path():
    n = math.prod(ndc.NOISE_SHAPE)
    tails = restarts = covered = 0
    for seed in FULL_SEEDS:
        st = ndc.generator(seed).bit_generator.state["state"]
        d = nd.draw_plain(st["state"], st["inc"], n, 0.0, 0.01, nd.first_budget(n))
        assert n < d.consumed < 1.04 * n  # about 2.2% of outputs are not values
        tails, restarts, covered = tails + d.tails, restarts + d.wedge_restarts, covered + d.covered
    assert tails > 0 and restarts > 0 and covered > 0


@pytest.mark.parametrize("delta", [0, 1, 2, 255, 256, 4097, 6_697_374, 2**40 + 3, 2**127 + 5])
def test_the_jump_ahead_is_pcg64s_advance(delta):
    bg = ndc.generator(SEED).bit_generator
    st = bg.state["state"]
    bg.advance(delta)
    assert nd.advance(st["state"], st["inc"], delta) == bg.state["state"]["state"]


@pytest.mark.parametrize("start,count", [(0, 1), (0, 1023), (5, 5000), (2**33, 2049)])
def test_the_plain_outputs_are_numpys_stream(start, count):
    bg = ndc.generator(7).bit_generator
    st = bg.state["state"]
    bg.advance(start)
    np.testing.assert_array_equal(nd.raw_outputs(st["state"], st["inc"], start, count),
                                  bg.random_raw(count))


def test_the_tables_are_the_installed_numpys():
    got = nd.tables()
    want = ziggurat_tables.read_tables(ziggurat_tables.default_library())
    for g, name in zip(got, ziggurat_tables.TABLES):
        np.testing.assert_array_equal(g.view(np.uint64), np.array(want[name], np.uint64))


def test_a_short_budget_draws_again_with_the_same_bits():
    ndc.check_short_budget("cpu", SEED, (20_000,))
    assert nd.launch_counts["plain"] == 3  # short, short again at n, then 2n


@pytest.mark.parametrize("aug,std", [(False, 0.01), (True, 0.0)], ids=["aug-off", "std-0"])
def test_no_noise_is_zeros_on_the_device_and_draws_nothing(aug, std):
    from pd_fusion_torch.models.mil_attention_finetune import MilAttentionFineTuneModel

    model = MilAttentionFineTuneModel({"backbone": "resnet18", "pretrained": False,
                                       "noise_std": std, "hidden_dim": 8, "attn_dim": 4},
                                      device="cpu")
    rng, ref = ndc.generator(SEED), ndc.generator(SEED)
    *small, noise = model._aug_params(4, 3, 8, 8, rng, aug)
    assert isinstance(noise, torch.Tensor) and noise.shape == (4, 3, 8, 8)
    assert not noise.any()
    assert nd.launch_counts == {"kernel": 0, "plain": 0}
    if aug:  # angle, translation, scale and shift drawn, then nothing more
        ref.uniform(size=4), ref.uniform(size=(4, 2)), ref.uniform(size=4), ref.uniform(size=4)
    assert rng.bit_generator.state == ref.bit_generator.state


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(32))
def test_k3_is_numpys_draw_at_the_finetunes_noise(cuda, seed):
    ndc.check_draw(cuda, 3_000_000_000 + seed, ndc.NOISE_SHAPE, 0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("std", ndc.STDS)
@pytest.mark.parametrize("shape", ndc.SHAPES, ids=str)
def test_k3_is_numpys_draw_at_odd_sizes(cuda, shape, std):
    ndc.check_draw(cuda, SEED, shape, std)
    ndc.check_draw(cuda, SEED + 1, shape, std, buffered=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [ndc.NOISE_SHAPE, (3, 61, 157, 163), (4097,)], ids=str)
def test_k3_consumes_what_the_plain_version_does(cuda, shape):
    n = math.prod(shape)
    assert n < ndc.check_consumed(cuda, SEED, shape, 0.01) < 1.04 * n + 64


@pytest.mark.cuda
def test_k3_short_budget_draws_again_with_the_same_bits(cuda):
    ndc.check_short_budget(cuda, SEED)
    assert nd.launch_counts["kernel"] == 3 * nd.LAUNCHES


@pytest.mark.cuda
def test_the_finetunes_preparation_on_the_card_is_the_cpus(cuda):
    assert ndc.check_model_path(cuda, SEED) > 0


@pytest.mark.cuda
def test_k3_launches_and_counters_in_a_traced_finetune(cuda):
    from pd_fusion_torch.models.mil_attention_finetune import MilAttentionFineTuneModel

    L, hw, n_bags, tta = 4, 32, 8, 2
    model = MilAttentionFineTuneModel({
        "backbone": "resnet18", "pretrained": False, "slice_count": L,
        "target_shape": [hw, hw, hw], "input_size": 32, "batch_size": 4, "epochs": 1,
        "freeze_backbone_epochs": 0, "hidden_dim": 16, "attn_dim": 8, "train_aug": True,
        "balanced_batches": True, "tta_inference": tta}, device=cuda,
        make_rng=lambda: ndc.generator(SEED))
    g = np.random.default_rng(0)
    bags = [g.random((L, hw, hw), dtype=np.float32) for _ in range(n_bags)]
    y = (np.arange(n_bags) % 2).astype(np.float32)
    with profiling.tracing():
        model.train(bags, y)
        model.predict_proba(bags)
    torch.cuda.synchronize()
    counters = profiling.snapshot()["counters"]
    draws = counters["trainer:steps"] + counters["trainer:passes"]
    assert counters["trainer:noise_on_card"] == draws
    assert nd.launch_counts == {"kernel": nd.LAUNCHES * draws, "plain": 0}
    values = draws * 4 * L * hw * hw
    assert 1.0 < counters["trainer:noise_raw"] / values < 1.04
    # no host copy of the noise: the slices are the only [B, L, h, w] copy
    per_step = 4 * (4 * L * hw * hw + 2 * 4 * L + 7 * 4) + 4 * L * 16
    assert counters["trainer:h2d_bytes"] < draws * per_step
