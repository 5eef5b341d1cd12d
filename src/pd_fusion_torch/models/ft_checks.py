"""The MIL fine-tune step on the card against the same step on the CPU, for
``chip_smoke.py`` and the ``cuda``-marked tests.

One step of ``models/mil_attention_finetune.py::ft_step`` at the fine-tune
config's widths (ResNet-50 at 224^2, 160^2 slices, gated head 256/128,
focal loss, the config's learning rates, weight decay and clip), B=2 bags
of L=8 slices, the second row padding a ragged batch (valid 0), dropout
keeps given explicitly, from the same parameters and draws on both
devices: once with the gate at 0 and once at 1. Float32 on both, TF32 off
on the card. Tolerances:

- the loss to rtol ``LOSS_RTOL``;
- the running statistics within ``STATS_REL`` of their largest magnitude;
- the Adam moments within ``MOMENT_REL`` of their L2 norm: the backbone's
  gradients at a random init are ill-conditioned in float32 (two float32
  implementations differ by 1-2% in L2 on the early layers, see
  ``tests/test_torch_port_resnet.py::_grad_close``);
- the weights: Adam's first step is about +-lr a weight whatever the
  gradient's size, so the devices' weights may differ by up to 2 lr where
  a gradient is within their float32 disagreement. So each device's new
  weights must be its start minus ``lr * mu_hat / (sqrt(nu_hat) + eps)``
  of its own moments, within ``WEIGHT_ATOL`` (float64 on the host), and
  the moments agree as above; with the gate at 0 the backbone's weights
  equal the start bit for bit.
"""
from typing import Dict

import numpy as np
import torch

from pd_fusion_torch.models import mil_attention_finetune as ft
from pd_fusion_torch.nn import ft_optim
from pd_fusion_torch.nn.mil import mil_init
from pd_fusion_torch.nn.resnet import BN_STATS, load_backbone, params_to

ARCH, SIZE, HW, HIDDEN, ATTN = "resnet50", 224, 160, 256, 128
LR_BACKBONE, LR = 1e-4, 3e-4  # configs/openneuro_ds001907_resnet2d_mil_ft.yaml
LOSS_RTOL = 1e-4
STATS_REL = 1e-4
MOMENT_REL = 0.05
WEIGHT_ATOL = 1e-6


def hyper(device, loss_type="focal") -> Dict:
    half = torch.full((3,), 0.5, device=device)
    return {"arch": ARCH, "gated": True, "input_size": SIZE, "mean": half, "std": half,
            "loss_type": loss_type, "pos_weight": 1.0, "focal_gamma": 2.0, "focal_alpha": 0.25,
            "head_dropout": 0.2, "lr_backbone": LR_BACKBONE, "lr": LR, "weight_decay": 1e-3,
            "max_grad_norm": 1.0}


def step_inputs(B=2, L=8, hw=HW, seed=0, ragged=True) -> Dict[str, np.ndarray]:
    """A batch as ``MilAttentionFineTuneModel.train`` forms it; with
    ``ragged`` the last row pads a ragged batch (valid 0) and row 0 is one
    slice short."""
    rng = np.random.default_rng(seed)
    slices = rng.random((B, L, hw, hw), dtype=np.float32)
    mask = np.ones((B, L), np.float32)
    valid = np.ones(B, np.float32)
    if ragged:
        mask[0, -1] = 0.0
        slices[0, -1] = 0.0
        valid[-1] = 0.0
        slices[-1] = 0.0
        mask[-1] = 0.0
    y = (np.arange(B) % 2 == 0).astype(np.float32)
    return {
        "slices": slices, "bag_mask": mask, "y": y, "valid": valid,
        "bn_mask": np.repeat(valid[:, None], L, 1),
        "angle": rng.uniform(-8, 8, B).astype(np.float32),
        "translate": (rng.uniform(-0.05, 0.05, (B, 2)) * hw).astype(np.float32),
        "scale": (1 + rng.uniform(-0.15, 0.15, B)).astype(np.float32),
        "shift": rng.uniform(-0.15, 0.15, B).astype(np.float32),
        "noise": rng.normal(0.0, 0.02, (B, L, hw, hw)).astype(np.float32),
        "keep": rng.random((B, L, HIDDEN)) < 0.8,
    }


def start_params(seed=0):
    """(backbone, head) as CPU tensors: the seeded ResNet-50 and a gated head."""
    backbone, dim, _ = load_backbone(ARCH, seed=seed)
    head = mil_init(torch.Generator().manual_seed(seed + 1), dim, HIDDEN, ATTN, True)
    return backbone, head


def run_step(backbone, head, inputs, gate, device):
    """One ``ft_step`` on ``device`` from CPU ``backbone``/``head`` -> CPU
    (backbone, head, Adam state, loss)."""
    bp, hp = params_to(backbone, device=device), params_to(head, device=device)
    state = {"backbone": ft_optim.init_group(ft.trainable_leaves(bp)),
             "head": ft_optim.init_group(ft.trainable_leaves(hp))}
    batch = {k: torch.as_tensor(v, device=device) for k, v in inputs.items()}
    bp, hp, loss = ft.ft_step(bp, hp, state, batch, gate, hyper(device))
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    state = {g: {"count": s["count"], "mu": [cpu(t) for t in s["mu"]],
                 "nu": [cpu(t) for t in s["nu"]]} for g, s in state.items()}
    return (ft._map_tensors(bp, cpu), ft._map_tensors(hp, cpu), state, float(loss))


def _adam_error(start, new, state, lr) -> float:
    """Largest distance of ``new`` from ``start`` moved by one Adam step of
    ``state``'s moments (float64)."""
    t = state["count"]
    worst = 0.0
    for w0, w1, m, v in zip(start, new, state["mu"], state["nu"]):
        m_hat = m.double() / (1 - ft_optim.BETA1 ** t)
        v_hat = v.double() / (1 - ft_optim.BETA2 ** t)
        want = w0.double() - lr * m_hat / (torch.sqrt(v_hat) + ft_optim.EPS)
        worst = max(worst, float((w1.double() - want).abs().max()))
    return worst


def compare(card, cpu, start, gate) -> Dict[str, float]:
    """Raise unless the card's step (``run_step``'s output) equals the CPU's
    from ``start`` = (backbone, head) within the module's tolerances. ->
    the largest errors."""
    (cb, ch, cs, closs), (wb, wh, ws, wloss) = card, cpu
    out = {"loss_rel_err": abs(closs - wloss) / max(abs(wloss), 1e-30)}
    if out["loss_rel_err"] > LOSS_RTOL:
        raise AssertionError(f"loss {closs} on the card, {wloss} on the CPU")
    stats = [(k, a, b) for (k, a), (_, b) in zip(ft._flatten(cb), ft._flatten(wb))
             if k in BN_STATS]
    out["stats_max_abs_err"] = max(float((a - b).abs().max()) for _, a, b in stats)
    for k, a, b in stats:
        if float((a - b).abs().max()) > STATS_REL * float(b.abs().max()):
            raise AssertionError(f"running {k}: {float((a - b).abs().max()):.3e}")
    out["moment_rel_err"] = 0.0
    for g in ("backbone", "head"):
        if not cs[g]["count"] == ws[g]["count"] == 1:
            raise AssertionError(f"{g} Adam count {cs[g]['count']} vs {ws[g]['count']}")
        for name in ("mu", "nu"):
            for a, b in zip(cs[g][name], ws[g][name]):
                rel = float(torch.linalg.vector_norm(a - b)) / max(
                    float(torch.linalg.vector_norm(b)), 1e-30)
                if rel > MOMENT_REL:
                    raise AssertionError(f"{g} Adam {name}: {rel:.3e} of its norm")
                out["moment_rel_err"] = max(out["moment_rel_err"], rel)
    out["weight_max_abs_err"] = out["adam_step_err"] = 0.0
    for g, trees, lr, s0 in (("backbone", (cb, wb), LR_BACKBONE, start[0]),
                             ("head", (ch, wh), LR, start[1])):
        w0 = ft.trainable_leaves(s0)
        got, want = (ft.trainable_leaves(t) for t in trees)
        if g == "backbone" and not gate:
            if not all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(got, want, w0)):
                raise AssertionError("a frozen backbone moved")
            continue
        for new, state in ((got, cs[g]), (want, ws[g])):
            err = _adam_error(w0, new, state, lr)
            if err > WEIGHT_ATOL:
                raise AssertionError(f"{g}: weights {err:.3e} from their own Adam step")
            out["adam_step_err"] = max(out["adam_step_err"], err)
        out["weight_max_abs_err"] = max(out["weight_max_abs_err"], max(
            float((a - b).abs().max()) for a, b in zip(got, want)))
    return out


def compare_card_with_cpu(device="cuda", B=2, L=8, seed=0) -> Dict[str, Dict[str, float]]:
    """One step with the gate at 0 and one at 1, each from the same start on
    the card and on the CPU. -> {"gate0": errors, "gate1": errors}."""
    backbone, head = start_params(seed)
    inputs = step_inputs(B, L, seed=seed)
    out = {}
    for gate in (0.0, 1.0):
        card = run_step(backbone, head, inputs, gate, device)
        cpu = run_step(backbone, head, inputs, gate, "cpu")
        out[f"gate{int(gate)}"] = compare(card, cpu, (backbone, head), gate)
    return out
