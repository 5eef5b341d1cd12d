"""The control on a card: the reference in TF32, put in the program's
place, fails a cell's limits, where the program passes them. At a reduced
size (the cells' widths, 16 bags of 16 slices of 96^2 taken to 128^2), on
three seeds; the full-size readings are ``calibrate.py``'s (PERF.md).
Run on the card with ``python -m pytest benchmark/tests -m cuda``."""
import pytest

from benchmark.harness import compare

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
REDUCED = {"target_shape": [96, 96, 96], "slice_count": 16, "input_size": 128}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ft_train.resnet50", "ft_train.resnet18"])
@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_fails(cuda_device, tiny, name, seed):
    cell = tiny(name, cell_arch(name), **REDUCED)
    drive = cell.drive(cell, seed, cuda_device)
    drive.setup()
    drive.call()
    drive.release()
    for rec in (drive.first, drive.last):
        ref = drive.reference(rec)
        ok, checks = compare.judge(drive.numbers(rec, ref), cell.limits)
        assert ok, checks
    control = drive.numbers(drive.as_observed(drive.reference(rec, tf32=True), rec), ref)
    ok, checks = compare.judge(control, cell.limits)
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_predict_control_fails(cuda_device, tiny, seed):
    cell = tiny("ft_predict.resnet50", "resnet50", **REDUCED)
    drive = cell.drive(cell, seed, cuda_device)
    drive.setup()
    drive.call()
    drive.release()
    ref = drive.reference([1])
    ok, _ = compare.judge(drive.numbers({1: drive.outputs[1]}, ref), cell.limits)
    assert ok
    ok, checks = compare.judge(drive.numbers(drive.reference([1], tf32=True), ref), cell.limits)
    assert not ok, checks


def cell_arch(name: str) -> str:
    return "resnet50" if name.endswith("resnet50") else "resnet18"
