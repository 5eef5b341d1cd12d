"""The reference against the port at a tiny size on the CPU: one training
call's first steps and one TTA predict, on the same weights and draws,
through the drives the benchmark's runs use."""
import numpy as np
import pytest
import torch

from benchmark.harness import compare
from benchmark.reference import mil_ft, resnet


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_first_training_steps(tiny, arch):
    cell = tiny("ft_train.resnet50", arch)
    drive = cell.drive(cell, 2**31 + 11, "cpu")
    drive.setup()
    drive.release()
    ref = drive.reference(drive.first)
    # the first step's loss is the forward alone: float32 rounding, which
    # ResNet-50's train-mode BN over 16 images of 1x1 in its last stage
    # (32^2 inputs) magnifies on the CPU
    assert compare.relative(drive.first["loss"][0], ref[0]["loss"]) < 1e-4
    nums = drive.numbers(drive.first, ref)
    assert nums["grad_gap"] < (1e-3 if arch == "resnet18" else 1e-2), (nums, drive.worst_grad)
    assert "attn_w.b" in drive.unmoved  # a bias under the softmax: no gradient
    if arch == "resnet18":
        assert nums["loss_gap"] < 1e-4 and nums["change_gap"] < 1e-3, nums


def test_tta_predict(tiny):
    cell = tiny("ft_predict.resnet50")
    drive = cell.drive(cell, 2**31 + 12, "cpu")
    drive.setup()
    drive.call()
    drive.release()
    ref = drive.reference([0, 1])
    nums = drive.numbers({0: drive.outputs[0], 1: drive.outputs[1]}, ref)
    assert nums["prob_gap"] < 1e-5, nums
    assert not np.array_equal(ref[0], ref[1])  # each call has draws of its own


def test_a_window_call_starts_where_the_last_ended(tiny):
    """The reference follows a later call from the parameters the program
    had when it began, with that call's own draws."""
    cell = tiny("ft_train.resnet18")
    drive = cell.drive(cell, 2**31 + 13, "cpu")
    drive.setup()
    drive.call()
    drive.release()
    assert (drive.first["call"], drive.last["call"]) == (0, 1)
    start = {**drive.last["start"][0], **drive.last["start"][1]}
    init = {**drive.first["start"][0], **drive.first["start"][1]}
    assert any(not torch.equal(start[k], init[k]) for k in init)
    nums = drive.numbers(drive.last, drive.reference(drive.last))
    assert nums["first_loss_gap"] < 1e-4 and nums["change_gap"] < 1e-3, nums


def test_reference_resnet_matches_torch_layout(tiny):
    """The reference ResNet's table against the published parameter count."""
    count = {a: sum(c.cout * c.cin * c.k * c.k for c in resnet.convs(a))
             for a in ("resnet18", "resnet50")}
    # torchvision's totals less the classifier and the BN parameters
    assert count["resnet18"] == 11_689_512 - 513_000 - 9_600
    assert count["resnet50"] == 25_557_032 - 2_049_000 - 53_120


def test_affine_is_identity_at_rest():
    x = torch.rand(2, 3, 8, 8)
    d = {"angle": torch.zeros(2), "translate": torch.zeros(2, 2), "scale": torch.ones(2),
         "shift": torch.zeros(2), "noise": torch.zeros(2, 3, 8, 8)}
    assert torch.equal(mil_ft.augment(x, d), x)
