"""``flops.py`` against ``torch.utils.flop_counter.FlopCounterMode`` over
the reference on the meta device: the backbone's forward, a training
step's forward and gradients (no stem data gradient), a predict pass."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops
from benchmark.harness import weights
from benchmark.reference import mil_ft, resnet

H, A = 256, 128


def _nets(arch, device="meta"):
    bp = {}
    for c in resnet.convs(arch):
        bp[f"{c.name}.weight"] = torch.empty(c.cout, c.cin, c.k, c.k, device=device)
        for k in ("weight", "bias", "running_mean", "running_var"):
            bp[f"{c.bn}.{k}"] = torch.ones(c.cout, device=device)
    hp = {f"{n}.{k}": torch.empty(*(s if k == "w" else s[1:]), device=device)
          for n, s in weights.head_shapes(resnet.emb_dim(arch), H, A).items() for k in ("w", "b")}
    return bp, hp


def _count(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
@pytest.mark.parametrize("size", [224, 64])
def test_backbone_forward(arch, size):
    bp, _ = _nets(arch)
    x = torch.empty(2, 3, size, size, device="meta")
    f, stem = flops.backbone_forward(arch, size)
    assert _count(lambda: resnet.forward(bp, x, arch, train=False)) == 2 * f
    assert stem == 2 * 64 * 3 * 49 * ((size + 6 - 7) // 2 + 1) ** 2


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_train_step(arch):
    bp, hp = _nets(arch)
    B, L, size = 2, 3, 224
    leaves = {k: bp[k].requires_grad_(True) for k in resnet.trainable(arch)}
    hl = {k: v.requires_grad_(True) for k, v in hp.items()}
    x = torch.empty(B * L, 3, size, size, device="meta")

    def step():
        emb, _ = resnet.forward(bp, x, arch, train=True)
        logits = mil_ft.head_forward(hl, emb.reshape(B, L, -1), torch.ones(B, L, device="meta"))
        loss = mil_ft.focal_loss(logits, torch.ones(B, device="meta"),
                                 torch.ones(B, device="meta"), 2.0, 0.25)
        torch.autograd.grad(loss, list(leaves.values()) + list(hl.values()))

    assert _count(step) == flops.train_step(arch, size, B, L, H, A)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_predict_pass(arch):
    bp, hp = _nets(arch)
    B, L, size = 2, 3, 224
    x = torch.empty(B * L, 3, size, size, device="meta")

    def forward():
        emb, _ = resnet.forward(bp, x, arch, train=False)
        mil_ft.head_forward(hp, emb.reshape(B, L, -1), torch.ones(B, L, device="meta"))

    assert _count(forward) == flops.predict_pass(arch, size, B, L, H, A)


def test_published_totals():
    """The step FLOPs the cells' per-layer metrics divide by."""
    assert flops.backbone_train("resnet50", 224, 256) == 6_217_418_145_792
    assert flops.backbone_train("resnet18", 224, 256) == 2_725_207_080_960
