"""The MIL fine-tune's host preparation one item ahead on a worker thread
(``pd_fusion_torch/models/mil_attention_finetune.py::_prepared_ahead``).

- ``train`` (class-balanced and permuted batches, a ragged final batch, a
  batch of ``None`` bags alone that is not stepped, two epochs) and a TTA-2
  ``predict_proba`` give ``ft_step`` and ``augment`` exactly the arrays that
  one thread drawing from the call's generator in the documented order
  (``benchmark/harness/draws.py``) gives; every copy is made on the
  caller's thread, in the order of the step's batch, and every draw on the
  worker; the draws, the waits and the ready items are counted once a step
  and a pass. The interpreter switches threads every microsecond here.
- A bag whose load raises, and a step that raises, reach the caller with
  their own types; after a normal call, a raised call and an early-stopped
  ``train``, no thread is left running.

The module imports no JAX: ``python -m pytest tests/test_torch_port_finetune_prep.py -q``.
"""
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from pd_fusion_torch.models import mil_attention_finetune as mft
from pd_fusion_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from benchmark.harness import draws  # noqa: E402

N_BAGS, L, HW, BS, HIDDEN, TTA, EPOCHS, SEED = 10, 4, 32, 4, 16, 2, 2, 7
PARAMS = {"backbone": "resnet18", "pretrained": False, "target_shape": [HW, HW, HW],
          "slice_count": L, "input_size": 32, "batch_size": BS, "epochs": EPOCHS,
          "freeze_backbone_epochs": 1, "early_stopping_patience": 0, "hidden_dim": HIDDEN,
          "attn_dim": 8, "gated": True, "dropout": 0.2, "train_aug": True,
          "loss_type": "focal", "tta_inference": TTA}
AUG = {"max_rotation_deg": 5.0, "max_translation": 0.05, "intensity_scale": 0.1,
       "intensity_shift": 0.1, "noise_std": 0.01}  # the model's defaults
# the arrays a step copies, in the order ``train`` copies them
STEP_KEYS = ("slices", "bag_mask", "y", "valid", "bn_mask", "angle", "translate", "scale",
             "shift", "noise", "keep")


@pytest.fixture(autouse=True)
def _registry_and_switching():
    profiling.reset()
    n, interval = torch.get_num_threads(), sys.getswitchinterval()
    torch.set_num_threads(1)
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(interval)
        torch.set_num_threads(n)
        profiling.reset()


def _rng():
    return np.random.Generator(np.random.PCG64(SEED))


def _model(balanced, **params):
    return mft.MilAttentionFineTuneModel(dict(PARAMS, balanced_batches=balanced, **params),
                                         device="cpu", make_rng=_rng)


def _bags(with_none=True):
    """Ten bags; with ``with_none``, those of the first epoch's second
    permuted batch are None."""
    g = np.random.default_rng(0)
    bags = [g.random((L, HW, HW), dtype=np.float32) for _ in range(N_BAGS)]
    for i in _rng().permutation(N_BAGS)[BS: 2 * BS] if with_none else []:
        bags[i] = None
    return bags


def _keeps():
    g = np.random.default_rng(3)
    return lambda B, L_, H: g.random((B, L_, H)) < 0.8


def _replay_train(bags, y, balanced):
    """Every step's host arrays from one thread, in the documented order."""
    rng, keep, steps = _rng(), _keeps(), []
    for _ in range(EPOCHS):
        if balanced:
            idx = draws.balanced_batches(y, rng, BS)
        else:
            perm = rng.permutation(N_BAGS)
            idx = [perm[i: i + BS] for i in range(0, N_BAGS, BS)]
        for b in idx:
            if all(bags[i] is None for i in b):
                continue
            step = {"slices": np.zeros((BS, L, HW, HW), np.float32),
                    "bag_mask": np.zeros((BS, L), np.float32), "y": np.zeros(BS, np.float32),
                    "valid": np.zeros(BS, np.float32)}
            for j, i in enumerate(b):
                if bags[i] is not None:
                    step["slices"][j], step["bag_mask"][j] = bags[i], 1.0
            step["valid"][:len(b)] = 1.0
            step["y"][:len(b)] = y[b]
            step["bn_mask"] = np.repeat(step["valid"][:, None], L, 1)
            step.update(draws.aug(rng, BS, L, HW, HW, AUG))
            step["keep"] = keep(BS, L, HIDDEN)
            steps.append(step)
    return steps


def _replay_predict(bags):
    rng = _rng()
    present = [i for i, b in enumerate(bags) if b is not None]
    return [draws.aug(rng, len(present[s: s + BS]), L, HW, HW, AUG)
            for s in range(0, len(present), BS) for _ in range(TTA)]


@pytest.mark.parametrize("balanced", [True, False], ids=["balanced", "permuted"])
def test_prepared_ahead_gives_the_sequential_draws_in_order(balanced, monkeypatch):
    bags = _bags()
    y = (np.arange(N_BAGS) % 2).astype(np.float32)
    model = _model(balanced)
    main = threading.current_thread()
    seen = {"steps": [], "passes": [], "copies": [], "draw_threads": set()}
    step, aug, copy = mft.ft_step, mft.augment, mft.MilAttentionFineTuneModel._t
    draw = mft.MilAttentionFineTuneModel._aug_params

    def observed_step(backbone, head, opt_state, batch, *args, **kwargs):
        seen["steps"].append({k: v.numpy().copy() for k, v in batch.items()})
        return step(backbone, head, opt_state, batch, *args, **kwargs)

    def observed_augment(x, *params):
        seen["passes"].append([p.numpy().copy() for p in params])
        return aug(x, *params)

    def observed_copy(self, a, dtype=np.float32):
        seen["copies"].append((threading.current_thread() is main, np.shape(a)))
        return copy(self, a, dtype)

    def observed_draw(self, *args):
        seen["draw_threads"].add(threading.current_thread() is main)
        return draw(self, *args)

    monkeypatch.setattr(mft, "ft_step", observed_step)
    monkeypatch.setattr(mft.MilAttentionFineTuneModel, "_t", observed_copy)
    monkeypatch.setattr(mft.MilAttentionFineTuneModel, "_aug_params", observed_draw)
    with profiling.tracing():
        model.train(bags, y, dropout_keep_fn=_keeps())
        monkeypatch.setattr(mft, "augment", observed_augment)  # the step augments too
        model.predict_proba(bags)

    want = _replay_train(bags, y, balanced)
    assert len(seen["steps"]) == len(want)
    for got, ref in zip(seen["steps"], want):
        assert tuple(got) == STEP_KEYS
        for k in STEP_KEYS:
            assert np.array_equal(got[k], ref[k]), k
    if not balanced:  # the skipped batch of None bags; each epoch ends in a batch of 2
        assert len(want) == EPOCHS * 3 - 1
        assert [s["valid"].sum() for s in want] == [4, 2, 4, 4, 2]
    passes = _replay_predict(bags)
    assert len(seen["passes"]) == len(passes)
    for got, ref in zip(seen["passes"], passes):
        for g, k in zip(got, ("angle", "translate", "scale", "shift", "noise")):
            assert np.array_equal(g, ref[k]), k

    # every copy on the caller's thread; after the mean and the std, each
    # step's in its batch's order
    assert all(on_main for on_main, _ in seen["copies"])
    step_shapes = [np.shape(want[0][k]) for k in STEP_KEYS]
    assert [s for _, s in seen["copies"]][2: 2 + len(STEP_KEYS) * len(want)] == (
        step_shapes * len(want))
    assert seen["draw_threads"] == {False}
    n = len(seen["steps"]) + len(seen["passes"])
    snap = profiling.snapshot()
    assert snap["spans"]["trainer:_aug_params"]["count"] == n
    assert snap["spans"]["trainer:prep_wait"]["count"] == n
    assert 0 <= snap["counters"].get("trainer:prep_ready", 0) <= n


class BagError(Exception):
    pass


def _unreadable(monkeypatch):
    load = mft.native.prep_slices_native

    def prep(path, *args, **kwargs):
        if str(path) == "unreadable.nii.gz":
            raise BagError(path)
        return load(path, *args, **kwargs)

    monkeypatch.setattr(mft.native, "prep_slices_native", prep)


def test_a_raise_on_either_thread_reaches_the_caller_and_no_thread_is_left(monkeypatch):
    bags = _bags(with_none=False)
    y = (np.arange(N_BAGS) % 2).astype(np.float32)
    before = threading.active_count()
    model = _model(False)
    model.train(bags, y)
    model.predict_proba(bags)
    assert threading.active_count() == before

    _unreadable(monkeypatch)
    bad = [b if i != 9 else "unreadable.nii.gz" for i, b in enumerate(bags)]
    with pytest.raises(BagError):
        _model(False).train(bad, y)
    assert threading.active_count() == before
    with pytest.raises(BagError):
        _model(False).predict_proba(bad)
    assert threading.active_count() == before

    step, calls = mft.ft_step, []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:  # while the worker prepares the third
            raise FloatingPointError("step 2")
        return step(*args, **kwargs)

    monkeypatch.setattr(mft, "ft_step", failing)
    with pytest.raises(FloatingPointError, match="step 2"):
        _model(False).train(bags, y)
    assert threading.active_count() == before


def test_an_early_stopped_train_leaves_no_thread(monkeypatch):
    bags = _bags(with_none=False)
    y = (np.arange(N_BAGS) % 2).astype(np.float32)
    steps = []
    step = mft.ft_step
    monkeypatch.setattr(mft, "ft_step", lambda *a, **k: steps.append(1) or step(*a, **k))
    before = threading.active_count()
    # a validation set of one class reads AUC -1.0, which never improves
    model = _model(False, epochs=5, early_stopping_patience=2)
    model.train(bags, y, val_data=(bags[:2], np.zeros(2, np.float32)))
    assert len(steps) == 2 * 3  # stopped after two epochs of five
    assert threading.active_count() == before
