"""Run-to-run determinism of the port (``utils/determinism_checks.py``) on
the CPU: ECE's fixed-order bin sums against the JAX package's at 1e-6, the
device programs held to calling no aten op that adds with float atomics on
a CUDA device (except the ones justified here), the instruments themselves,
and ``chip_smoke.py`` phase 39's failure rule. The card's own checks (two
runs equal bit for bit) are the ``cuda``-marked tests of
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py`` phase 39."""
import importlib.util
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pd_fusion.ops import metrics as J
from pd_fusion_torch.ops import metrics as T
from pd_fusion_torch.utils import determinism_checks as dc
from test_torch_port_jax_draws import one_cpu_thread

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-6  # ECE against the JAX package's: float32 sums in another order


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    with one_cpu_thread():
        yield


def _ece_case(kind, seed=0, n=120):
    rng = np.random.RandomState(seed)
    y = (rng.rand(n) < 0.5).astype(np.float32)
    w = np.ones(n, np.float32)
    if kind == "edges":  # every bin edge k/10 in float32, 0 and 1 included
        p = (rng.randint(0, 11, n) / np.float32(10.0)).astype(np.float32)
    elif kind == "zeros":  # p == 0 falls in no bin
        p = rng.rand(n).astype(np.float32)
        p[: n // 3] = 0.0
    elif kind == "ties":
        p = (rng.randint(1, 4, n) / 4.0).astype(np.float32)
    elif kind == "zero_weights":  # a third at weight 0, one bin held only by them
        p = rng.rand(n).astype(np.float32)
        w[: n // 3] = 0.0
        p[: n // 3][p[: n // 3] > 0.9] = 0.95
        p[n // 3:] = np.minimum(p[n // 3:], 0.9)
    elif kind == "fractional_weights":
        p = rng.rand(n).astype(np.float32)
        w = rng.rand(n).astype(np.float32) * 3
    elif kind == "nan":  # a NaN probability lands in the first bin, as .at[].add puts it
        p = rng.rand(n).astype(np.float32)
        p[5] = np.nan
    else:
        p = rng.rand(n).astype(np.float32)
    return y, p, w


ECE_KINDS = ["random", "edges", "zeros", "ties", "zero_weights", "fractional_weights", "nan"]


@pytest.mark.parametrize("n_bins", [10, 15])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("kind", ECE_KINDS)
def test_ece_matches_jax(kind, weighted, n_bins):
    y, p, w = _ece_case(kind, seed=ECE_KINDS.index(kind))
    want = np.asarray(J.expected_calibration_error(
        jnp.asarray(y), jnp.asarray(p), jnp.asarray(w) if weighted else None, n_bins))
    got = T.expected_calibration_error(torch.from_numpy(y), torch.from_numpy(p),
                                       torch.from_numpy(w) if weighted else None, n_bins).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.isnan(got) == np.isnan(want)


@pytest.mark.parametrize("kind", ["random", "edges", "zeros", "zero_weights"])
def test_batched_ece_matches_a_loop_of_jax_calls(kind):
    """[n, N] in one call (the bootstrap's and the CV engine's layout)
    against the JAX function row by row."""
    rows = [_ece_case(kind, seed=10 + i, n=57) for i in range(4)]
    y, p, w = (np.stack(a) for a in zip(*rows))
    got = T.expected_calibration_error(*(torch.from_numpy(a) for a in (y, p, w))).numpy()
    want = [float(J.expected_calibration_error(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
            for a, b, c in zip(y, p, w)]
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_ece_calls_no_atomic_op_and_a_planted_scatter_add_is_caught():
    y, p, w = dc.ece_inputs(5, 200)
    assert dc.atomic_ops_called(lambda: T.expected_calibration_error(y, p, w)) == []
    assert dc.atomic_ops_called(lambda: dc.scatter_ece(y, p, w)) == ["scatter_add"]
    # the same function: the fixed-order sums change the order only
    torch.testing.assert_close(T.expected_calibration_error(y, p, w), dc.scatter_ece(y, p, w),
                               atol=ATOL, rtol=0)


# every program of determinism_checks.programs(size="small") and the ops of
# ATOMIC_ATEN_OPS it may call, each with its reason:
# - isotonic's _segment_sum adds 0/1 weights and 0/1 labels (integers, exact
#   in float32: any order gives the same sum; test below);
# - hist_mode: scatter is the GBDT's atomic lowering by name (by design:
#   auto never takes it on CUDA);
# - the CNN3D's 2x2x2/stride-2 max pool: windows do not overlap, so each
#   input element receives at most one add onto zero (equal twice on the
#   card, phase 39)
JUSTIFIED = {"isotonic_K2_Nc50": ["scatter_add"], "gbdt_scatter": ["index_add"],
             "cnn3d_train_step": ["max_pool3d_with_indices_backward"]}
PROGRAMS = ["ece_20x60", "bootstrap_metrics_20x60", "metrics_packed_K2_S2_N10", "ece_2x20",
            "tabular_trainer_K3", "fused_sweep_step_K3", "isotonic_K2_Nc50", "moe_trainer_K2",
            "gbdt_onehot", "gbdt_scatter", "gbdt_predict_margin", "mil_trainer_k1",
            "resnet50_embed_flush", "ft_step_frozen", "ft_step_unfrozen", "cnn3d_train_step",
            "simple_volume_features", "logreg_fit", "mlp_earlystop", "stress_fold",
            "treeshap_chunk"]


@pytest.fixture(scope="module")
def small_programs():
    with one_cpu_thread():
        return {p.name: p for p in dc.programs("cpu", "small")}


def test_programs_are_the_listed_ones(small_programs):
    assert list(small_programs) == PROGRAMS
    assert [p.name for p in small_programs.values() if not p.deterministic] == ["gbdt_scatter"]
    assert dc.program("ece_20x60", "cpu", "small").name == "ece_20x60"


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_calls_no_unjustified_atomic_op(small_programs, name):
    p = small_programs[name]
    call = (lambda: p.fn(p.make_state())) if p.make_state else p.fn
    assert dc.atomic_ops_called(call) == JUSTIFIED.get(name, [])


@pytest.mark.parametrize("name", ["ft_step_unfrozen", "ft_step_frozen"])
def test_ft_step_takes_no_convolution_backward(small_programs, name):
    """The ResNet's convolution gradients are the port's own
    (``nn/resnet.py::_Conv2d``): a fine-tune step dispatches no
    ``convolution_backward``, so on the card it never reaches cuDNN's
    backward kernels, which add with atomics; through ``F.conv2d``'s own
    autograd (``resnet_checks.cudnn_backward``) the unfrozen step does."""
    from pd_fusion_torch.nn import resnet_checks

    p = small_programs[name]
    ops = dc.aten_ops_called(lambda: p.fn(p.make_state()))
    assert "convolution" in ops and "convolution_backward" not in ops
    if name == "ft_step_unfrozen":
        with resnet_checks.cudnn_backward():
            assert "convolution_backward" in dc.aten_ops_called(lambda: p.fn(p.make_state()))


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_is_equal_twice_on_the_cpu(small_programs, name):
    p = small_programs[name]
    twice = dc.run_twice(p.fn, p.make_state)
    assert twice and all(eq and g == 0.0 for eq, g in twice.values()), twice
    assert p.source.startswith("src/pd_fusion_torch/") and int(p.source.rsplit(":", 1)[1]) > 0


def test_isotonic_segment_sums_are_of_integers(monkeypatch):
    """The scatter_add isotonic keeps sums 0/1 weights and labels and their
    integer segment sums: exact in float32, so the adds' order cannot move
    them."""
    from pd_fusion_torch.ops import isotonic
    from pd_fusion_torch.ops.isotonic_checks import fold_batched_inputs

    seen, segment_sum = [], isotonic._segment_sum

    def checked(values, ids):
        seen.append(bool(torch.equal(values, torch.round(values)))
                    and float(values.abs().sum()) < 2 ** 24)
        return segment_sum(values, ids)

    monkeypatch.setattr(isotonic, "_segment_sum", checked)
    isotonic.isotonic_fit_transform(*fold_batched_inputs(3, 200))
    assert seen and all(seen)


def test_run_twice_equal_on_a_pure_function_and_unequal_on_a_planted_one():
    x = torch.arange(50.0)
    pure = dc.run_twice(lambda: {"a": torch.cumsum(x, 0), "b": [x.sum(), 3]})
    assert set(pure) == {"a", "b.0", "b.1"} and all(eq for eq, _ in pure.values())

    calls = []

    def planted():
        calls.append(1)
        return {"same": x * 2, "moves": x + 0.25 * len(calls)}

    twice = dc.run_twice(planted)
    assert twice["same"] == (True, 0.0) and twice["moves"] == (False, 0.25)


def test_run_twice_rebuilds_the_state_for_each_run():
    def step(state):
        state["w"].add_(1.0)  # updates its state in place, as an optimizer step does
        return state["w"]

    assert all(eq for eq, _ in dc.run_twice(step, lambda: {"w": torch.zeros(3)}).values())
    shared = {"w": torch.zeros(3)}
    assert not all(eq for eq, _ in dc.run_twice(step, lambda: shared).values())


def test_gap_and_compare_on_nan_shapes_and_strings():
    a = np.array([1.0, np.nan, 2.0])
    assert dc.gap(a, a.copy()) == 0.0
    assert dc.gap(a, np.array([1.0, 0.0, 2.5])) == np.inf
    assert dc.gap(a, a[:2]) == np.inf
    got = dc.compare({"ids": np.array(["a", "b"]), "x": a}, {"ids": np.array(["a", "c"]), "x": a})
    assert got["ids"] == (False, np.inf) and got["x"] == (True, 0.0)
    # object arrays (a .npz's or a parquet's ids) by value, not by their pointers
    ids = lambda: np.array([str(i) * 3 for i in range(4)], dtype=object)  # noqa: E731
    assert dc.compare(ids(), ids()) == {"out": (True, 0.0)}
    assert dc.compare(ids(), ids()[::-1])["out"] == (False, np.inf)


def test_flagged_ops_collects_the_alerts_and_restores_the_mode():
    seen = []

    def fn():
        seen.append(torch.are_deterministic_algorithms_enabled())
        warnings.warn("scatter_add_cuda_kernel does not have a deterministic implementation, "
                      "but you set 'torch.use_deterministic_algorithms(True, warn_only=True)'")
        warnings.warn("an unrelated warning")

    assert not torch.are_deterministic_algorithms_enabled()
    assert dc.flagged_ops(fn) == ["scatter_add_cuda_kernel"]
    assert seen == [True] and not torch.are_deterministic_algorithms_enabled()
    with pytest.raises(ZeroDivisionError):
        dc.flagged_ops(lambda: 1 / 0)
    assert not torch.are_deterministic_algorithms_enabled()


def test_no_module_of_the_port_turns_on_deterministic_mode():
    """The deterministic mode is an instrument of the checks only."""
    port = ROOT / "src" / "pd_fusion_torch"
    users = sorted(str(p.relative_to(port)) for p in port.rglob("*.py")
                   if "use_deterministic_algorithms(" in p.read_text())
    assert users == ["utils/determinism_checks.py"]


@pytest.fixture
def chip_smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(module, "DEV", "cpu")
    return module


def _planted(deterministic):
    calls = []

    def fn():
        calls.append(1)
        return torch.full((4,), float(len(calls)))

    return dc.Program("planted", fn, None, "tests/planted.py:1", "4", deterministic, "planted")


def test_phase_39_fails_on_a_planted_difference(chip_smoke, capsys):
    from pd_fusion_torch.ops import attention_pool as ap

    with pytest.raises(RuntimeError, match="planted"):
        chip_smoke.determinism_programs(torch, ap, [_planted(True)])
    assert "phase 39: planted: equal twice no, max gap 1.000e+00" in capsys.readouterr().out
    # a by-design entry is printed with its gap and does not fail the run
    rows, _ = chip_smoke.determinism_programs(torch, ap, [_planted(False)])
    assert rows[0]["gap"] == 1.0 and not rows[0]["equal"]


def test_phase_39_fresh_process_rerun_equals_the_first_run(chip_smoke, tmp_path, capsys):
    """The single-split quickstart in this process, then again in a fresh
    ``chip_smoke.py --determinism-child``: results.yaml bit for bit."""
    import yaml

    from pd_fusion_torch import cli

    argv = ["run", "--config", str(ROOT / "configs" / "quickstart.yaml"), "--synthetic",
            "--output-dir"]
    cli.main(argv + [str(tmp_path / "first")])
    runs = [{"name": "quickstart", "module": "pd_fusion_torch.cli",
             "argv": argv + [str(tmp_path / "again")], "out": tmp_path / "again",
             "ref": chip_smoke.dir_artifacts(yaml, np, tmp_path / "first"), "expect_k1": False,
             "first": "this process", "what": "quickstart"}]
    rows, k1 = chip_smoke.determinism_rerun(np, yaml, tmp_path, runs)
    assert rows[0]["equal"] and rows[0]["gap"] == 0.0
    assert k1 == {"quickstart": {"kernel": 0, "plain": 0}}
    assert "results.yaml.full_observation.roc_auc" in dc.compare(runs[0]["ref"], runs[0]["ref"])
    assert "phase 39: quickstart: equal twice yes" in capsys.readouterr().out


def test_phase_39_fresh_process_reruns_the_finetune_single_split(chip_smoke, tmp_path, capsys):
    """Phase 22's fine-tune single split (a tiny copy of the fine-tune
    config on seeded volumes) in this process with its augmentation drawn
    from ``FT_DRAWS_SEED``, then again in a fresh ``--determinism-child``:
    ``results.yaml``, the predictions of ``model.pt`` and every tensor of
    ``model.pt`` bit for bit; a changed tensor is caught."""
    import pandas as pd
    import yaml

    from pd_fusion_torch import cli
    from pd_fusion_torch.imaging.nifti import write_nifti

    rng = np.random.RandomState(0)
    rows = []
    for i in range(12):
        vol = rng.rand(24, 28, 26).astype(np.float32) * 0.3
        vol[2:22, 2:26, 2:24] += 0.4
        vol[8:16, 8:16, 8:16] += 1.5 * (i % 2)
        path = tmp_path / f"sub-{i:02d}_T1w.nii.gz"
        write_nifti(path, vol)
        rows.append({"subject_id": f"sub-{i:02d}", "session": 1, "label": i % 2,
                     "t1wbrain_path": str(path)})
    pd.DataFrame(rows).to_csv(tmp_path / "manifest_ft.csv", index=False)
    cfg = yaml.safe_load(chip_smoke.FT_CONFIG.read_text())
    data_cfg = yaml.safe_load((ROOT / cfg["data_config"]).read_text())
    data_cfg["manifest_path"] = str(tmp_path / "manifest_ft.csv")
    (tmp_path / "data_ft.yaml").write_text(yaml.safe_dump(data_cfg))
    cfg.pop("cv_folds", None)
    cfg.update(data_config=str(tmp_path / "data_ft.yaml"),
               eval_config=str(ROOT / cfg["eval_config"]), calibration_split=0.5)
    cfg["params"].update({"backbone": "resnet18", "target_shape": [16, 16, 16], "slice_count": 4,
                          "input_size": 32, "hidden_dim": 16, "attn_dim": 8, "epochs": 2,
                          "freeze_backbone_epochs": 1, "tta_inference": 2})
    (tmp_path / "ft_single.yaml").write_text(yaml.safe_dump(cfg))
    first = tmp_path / "ft_single"
    bags = [r["t1wbrain_path"] for r in rows[:chip_smoke.FT_PREDICT_BAGS]]
    with chip_smoke.seeded_ft_draws():
        cli.main(["run", "--config", str(tmp_path / "ft_single.yaml"), "--output-dir", str(first)])
        np.savez(first / "predictions.npz",
                 y_prob=chip_smoke.predict_ft_bags(first / "model.pt", bags))
    spec = chip_smoke.ft_single_rerun_spec(yaml, np, tmp_path, tmp_path / "determinism")
    assert sorted(spec["ref"]) == ["model.pt", "predictions.npz", "results.yaml"]
    assert len(spec["ref"]["model.pt"]) > 100 and spec["predict_bags"] == bags
    rows_, k1 = chip_smoke.determinism_rerun(np, yaml, tmp_path, [spec])
    assert rows_[0]["equal"] and rows_[0]["gap"] == 0.0
    assert "phase 39: mil_ft_single: equal twice yes" in capsys.readouterr().out
    again = chip_smoke.dir_artifacts(yaml, np, spec["out"], True)
    name, leaf = next(iter(again["model.pt"].items()))
    again["model.pt"][name] = leaf + 1e-6
    assert not all(eq for eq, _ in dc.compare(spec["ref"], again).values())
