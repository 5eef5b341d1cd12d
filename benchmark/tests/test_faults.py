"""A run with the timed path broken underneath reads ``correct`` false,
once for each fault a cell can have, and a sound run reads true: tiny CPU
runs through ``runner.run`` (the look for a card skipped), judged by each
cell's own limits."""
import pytest
import torch

from benchmark.harness import runner
from pd_fusion_torch.models import mil_attention_finetune as mft

SEED = 2**31 + 5


def _run(cell):
    return runner.run(cell, SEED, 0.2, False, "cpu", log=lambda s: None)


@pytest.mark.parametrize("name", ["ft_train.resnet50", "ft_train.resnet18",
                                  "ft_predict.resnet50"])
def test_sound_run_is_correct(tiny, name):
    out = _run(tiny(name))
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["attempted"] > 0 and out["failed"] == 0


def test_state_unchanged(tiny, monkeypatch):
    step = mft.ft_step

    def unchanged(backbone, head, opt_state, batch, *args, **kwargs):
        loss = step(backbone, head, opt_state, batch, *args, **kwargs)[2]
        return backbone, head, loss

    monkeypatch.setattr(mft, "ft_step", unchanged)
    out = _run(tiny("ft_train.resnet50"))
    assert not out["correct"] and out["checks"]["change_gap"]["value"] > 0.5


def test_state_unchanged_after_the_first_call(tiny, monkeypatch):
    """A fault that only repeated calls show: the set-up's call is sound,
    and every step after it returns its state unchanged."""
    step, steps = mft.ft_step, []

    def stale(backbone, head, opt_state, batch, *args, **kwargs):
        out = step(backbone, head, opt_state, batch, *args, **kwargs)
        steps.append(1)
        return out if len(steps) <= 4 else (backbone, head, out[2])

    monkeypatch.setattr(mft, "ft_step", stale)
    out = _run(tiny("ft_train.resnet18"))
    assert not out["correct"] and out["checks"]["change_gap"]["value"] > 0.5, out["checks"]


def test_half_batch_left_out(tiny, monkeypatch):
    loss = mft.ft_loss

    def half(logits, y, valid, *args, **kwargs):
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = 0.0
        return loss(logits, y, valid, *args, **kwargs)

    monkeypatch.setattr(mft, "ft_loss", half)
    out = _run(tiny("ft_train.resnet50"))
    assert not out["correct"], out["checks"]


def test_predict_half_of_each_bag_left_out(tiny, monkeypatch):
    chunk = mft.MilAttentionFineTuneModel._predict_chunk

    def half(self, X, bag_mask):
        bag_mask = bag_mask.clone()
        bag_mask[:, bag_mask.shape[1] // 2:] = 0.0
        return chunk(self, X, bag_mask)

    monkeypatch.setattr(mft.MilAttentionFineTuneModel, "_predict_chunk", half)
    out = _run(tiny("ft_predict.resnet50"))
    assert not out["correct"], out["checks"]


def test_predict_answer_altered(tiny, monkeypatch):
    chunk = mft.MilAttentionFineTuneModel._predict_chunk

    def altered(self, X, bag_mask):
        p = chunk(self, X, bag_mask)
        return torch.cat([p[:1] * 0.99, p[1:]])

    monkeypatch.setattr(mft.MilAttentionFineTuneModel, "_predict_chunk", altered)
    out = _run(tiny("ft_predict.resnet50"))
    assert not out["correct"], out["checks"]
