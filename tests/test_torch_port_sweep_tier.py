"""The port's sweep tier beside the fused sweep: the aggregator, the bootstrap
CIs, the cross-run summary, both SLURM submitters' dry runs, and the torch
helpers (``pd_fusion_torch/{analysis,scripts,utils}``), against the JAX
package's on the JAX tests' own run directories (``tests/test_analysis.py``).

What is held, and how close:
- ``aggregate``: ``summary.csv``, ``summary_table.csv`` (and, for single
  runs, ``summary_aggregated.csv``) equal and ``summary_table.tex``
  identical, for CV run directories and for single-run directories;
- ``generate_summary``: ``final_benchmark_summary.csv`` equal, the ``.tex``
  identical and the PNG written where matplotlib is installed;
- the bootstrap: the resample indices are the JAX package's (numpy), each
  resample's six metrics from the one batched program within 1e-6 of the
  JAX ``lax.map`` (float32 reductions in another order), and the CIs within
  1e-6, pooled and collapsed to subject means;
- both submitters' ``--dry-run``: the same script files, their text equal
  but for the module name (``pd_fusion_torch.cli``) and the recorded GPU
  request (partition ``gpu`` and ``#SBATCH --gres=gpu:1`` in the sweep's
  template);
- ``bootstrap_ci`` and ``generate_summary`` with every ``sklearn`` and
  ``matplotlib`` module blocked (the card's machine): the CSVs and the
  ``.tex`` written, the PNG skipped;
- ``build_torch_resnet18``'s state_dict through ``convert_torch_state_dict``:
  the port's forward within 1e-4 of the torch module's in eval mode (BN
  from running statistics), and the export script's ``--src`` round trip.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from pd_fusion_torch.analysis import aggregate_results as TA
from pd_fusion_torch.analysis import bootstrap_ci as TB
from pd_fusion_torch.analysis import generate_summary as TG
from test_analysis import _make_cv_run
from test_torch_port_jax_draws import one_cpu_thread

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    with one_cpu_thread():
        yield


def _runs(root: Path):
    _make_cv_run(root / "cv_moddrop", "fusion_moddrop", 1, 0.85)
    _make_cv_run(root / "cv_moe", "moe", 2, 0.80)
    _make_cv_run(root / "cv_gbdt", "unimodal_gbdt", 3, 0.75)
    (root / "notes.txt").write_text("not a run")
    return root


def _single_runs(root: Path):
    import yaml

    for name, model, seed, auc in (("run_a", "fusion_late", 42, 0.7), ("run_b", "fusion_late", 43,
                                                                        0.72),
                                   ("moe_s42", None, None, 0.66)):
        d = root / name
        d.mkdir(parents=True)
        if model:
            yaml.safe_dump({"model_type": model}, open(d / "resolved_config.yaml", "w"))
            yaml.safe_dump({"seed": seed}, open(d / "provenance.yaml", "w"))
        yaml.safe_dump({"full_observation": {"roc_auc": auc, "ece": 0.1},
                        "no_mri": {"roc_auc": auc - 0.04, "ece": 0.12}},
                       open(d / "results.yaml", "w"))
    return root


@pytest.mark.parametrize("make", [_runs, _single_runs], ids=["cv-runs", "single-runs"])
def test_aggregate_equals_the_jax_aggregator(tmp_path, make):
    from pd_fusion.analysis import aggregate_results as JA

    runs = make(tmp_path / "runs")
    outs = {}
    for name, mod in (("jax", JA), ("port", TA)):
        out = tmp_path / name
        out.mkdir()
        outs[name] = (mod.aggregate(runs, out / "summary.csv"), out)
    (want, jdir), (got, tdir) = outs["jax"], outs["port"]
    pd.testing.assert_frame_equal(got, want)
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir()) and "summary_table.tex" in names
    for name in names:
        assert (tdir / name).read_text() == (jdir / name).read_text(), name


def test_generate_summary_equals_the_jax_summary(tmp_path):
    from pd_fusion.analysis import generate_summary as JG

    runs = _runs(tmp_path / "runs")
    run_dirs = [str(runs / n) for n in ("cv_moddrop", "cv_moe", "cv_gbdt", "missing")]
    want = JG.generate_summary(run_dirs, tmp_path / "jax")
    got = TG.generate_summary(run_dirs, tmp_path / "port")
    pd.testing.assert_frame_equal(got, want)
    for name in ("final_benchmark_summary.csv", "summary_table.tex"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert (tmp_path / "port" / "robustness_comparison.png").exists()


def _scores(n=300, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, n)
    # rounded: resamples repeat rows, and these add ties across rows
    p = np.round(np.clip(rng.rand(n) * 0.5 + y * 0.4, 0, 1), 3)
    return y, p


def test_bootstrap_resamples_equal_the_jax_lax_map():
    from pd_fusion.analysis import bootstrap_ci as JB

    y, p = _scores()
    want = JB.bootstrap_metrics(y, p, n=400, seed=7)
    got = TB.bootstrap_metrics(y, p, n=400, seed=7)
    assert set(got) == set(want) == {"roc_auc", "pr_auc", "balanced_accuracy", "f1",
                                     "brier_score", "ece"}
    for metric in want:
        assert got[metric].shape == (400,)
        np.testing.assert_allclose(got[metric], want[metric], rtol=0, atol=1e-6, err_msg=metric)
        np.testing.assert_allclose(np.percentile(got[metric], [2.5, 97.5]),
                                   np.percentile(want[metric], [2.5, 97.5]), rtol=0, atol=1e-6)
    # one resample through the per-vector program: the batched rows are it
    from pd_fusion_torch.ops.metrics import binary_metrics

    idx = TB.resample_indices(len(y), 400, 7)
    one = binary_metrics(torch.as_tensor(y[idx[5]], dtype=torch.float32),
                         torch.as_tensor(p[idx[5]], dtype=torch.float32))
    for metric, v in one.items():
        assert float(v) == pytest.approx(float(got[metric][5]), abs=1e-6)


@pytest.mark.parametrize("group_col", ["", "subject_id"])
def test_run_bootstrap_equals_the_jax_run(tmp_path, group_col):
    from pd_fusion.analysis import bootstrap_ci as JB

    runs = _runs(tmp_path)
    if group_col:  # two folds' rows of the same 30 subjects
        for d in runs.glob("cv_*"):
            for f in d.glob("preds_fold_*.csv"):
                frame = pd.read_csv(f)
                frame["subject_id"] = np.arange(len(frame)) % 20
                frame.to_csv(f, index=False)
    want = pd.read_csv(JB.run_bootstrap(runs, n=200, group_col=group_col)).sort_values(
        ["Model", "Metric"]).reset_index(drop=True)
    got = pd.read_csv(TB.run_bootstrap(runs, n=200, group_col=group_col)).sort_values(
        ["Model", "Metric"]).reset_index(drop=True)
    assert len(got) == 3 * 6 and set(got["Model"]) == {"fusion_moddrop", "moe",
                                                        "unimodal_gbdt"}
    pd.testing.assert_frame_equal(got[["Model", "Metric"]], want[["Model", "Metric"]])
    np.testing.assert_allclose(got[["CI_low", "CI_high"]], want[["CI_low", "CI_high"]], rtol=0,
                               atol=1e-6)


def _block(monkeypatch, *tops):
    for name in [m for m in sys.modules if m.split(".")[0] in tops]:
        monkeypatch.setitem(sys.modules, name, None)
    for top in tops:
        monkeypatch.setitem(sys.modules, top, None)


def test_bootstrap_and_summary_run_without_scikit_learn_or_matplotlib(tmp_path, monkeypatch):
    _block(monkeypatch, "sklearn", "matplotlib", "seaborn")
    with pytest.raises(ImportError):
        import matplotlib.pyplot  # noqa: F401
    runs = _runs(tmp_path / "runs")
    ci = pd.read_csv(TB.main(["--sweep-dir", str(runs), "--n", "100"]))
    assert len(ci) == 18 and (ci["CI_low"] <= ci["CI_high"]).all()
    df = TG.main(["--runs", str(runs / "cv_moddrop"), str(runs / "cv_moe"),
                  "--output", str(tmp_path / "summary")])
    assert set(df["Model"]) == {"moddrop", "moe"}
    names = {p.name for p in (tmp_path / "summary").iterdir()}
    assert names == {"final_benchmark_summary.csv", "summary_table.tex"}


def _dry_run(cmd, tmp_path, name, args):
    out = subprocess.run([sys.executable, *cmd, *args], cwd=tmp_path / name, capture_output=True,
                         text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    sweep = next((tmp_path / name / "runs").glob("*sweep_*"))
    return {p.name: p.read_text().replace(str(sweep.resolve()), "<sweep>")
            .replace(sweep.name, "<sweep>") for p in sorted((sweep / "scripts").glob("*.sh"))}


SUBMITTERS = {
    "submit_sweep": ["--dry-run", "--synthetic", "--models", "fusion_moddrop,moe", "--k-fold", "5",
                     "--dataset", "ppmi"],
    "submit_dual_h200": ["--dry-run", "--dataset", "openneuro_ds001907", "--k-fold", "5",
                         "--models", "fusion_moddrop,moe,fusion_late", "--conda-env", "none"],
}


@pytest.mark.parametrize("script", list(SUBMITTERS))
def test_submitter_dry_runs_equal_the_jax_scripts(tmp_path, script):
    args = SUBMITTERS[script]
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    want = _dry_run([str(REPO / "scripts" / f"{script}.py")], tmp_path, "jax", args)
    got = _dry_run(["-m", f"pd_fusion_torch.scripts.{script}"], tmp_path, "port", args)
    assert list(got) == list(want) and len(got) == (6 if script == "submit_sweep" else 2)
    for name, text in want.items():
        expect = text.replace("python -m pd_fusion.cli run", "python -m pd_fusion_torch.cli run")
        if script == "submit_sweep":
            expect = expect.replace("#SBATCH --partition=tpu\n",
                                    "#SBATCH --partition=gpu\n#SBATCH --gres=gpu:1\n")
        assert got[name] == expect, name
    joined = "".join(got.values())
    assert joined.count("python -m pd_fusion_torch.cli run") == (6 if script == "submit_sweep"
                                                                 else 9)
    assert "--k-fold 5" in joined and "pd_fusion.cli" not in joined


def test_torch_resnet18_state_dict_loads_and_matches_in_eval_mode(tmp_path):
    from pd_fusion_torch.nn.resnet import convert_torch_state_dict, resnet_apply
    from pd_fusion_torch.scripts import export_backbone_weights
    from pd_fusion_torch.utils.device import get_device
    from pd_fusion_torch.utils.torch_utils import build_torch_resnet18, get_torch_device

    assert get_torch_device() == get_device() == torch.device("cpu")
    torch.manual_seed(0)
    net = build_torch_resnet18()
    with torch.no_grad():  # running statistics away from their init
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    net.eval()
    x = torch.randn(2, 3, 64, 64)
    with torch.no_grad():
        want = net(x)
        params = convert_torch_state_dict(net.state_dict(), "resnet18")
        got = resnet_apply(params, x.permute(0, 2, 3, 1), "resnet18")
    assert got.shape == want.shape == (2, 512)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)

    torch.save(net.state_dict(), tmp_path / "sd.pth")
    export_backbone_weights.main(["--src", str(tmp_path / "sd.pth"), "--out",
                                  str(tmp_path / "w.npz")])
    data = np.load(tmp_path / "w.npz")
    assert set(data.files) == set(net.state_dict())
    with pytest.raises(SystemExit, match="torchvision is not installed"):
        export_backbone_weights.main(["--out", str(tmp_path / "x.npz")])


def test_sweep_checks_run_on_the_cpu(tmp_path):
    """``analysis/sweep_checks.py``, which the card runs against the CPU,
    run here with the CPU on both sides (equal by construction), and the
    fused sweep's standalone gaps on equal folds (0 up to rounding)."""
    from pd_fusion_torch.analysis import sweep_checks as sc
    from pd_fusion_torch.parallel.seed_sweep import run_multi_seed_cv
    from pd_fusion_torch.utils.io import load_yaml

    assert sc.check_bootstrap("cpu", n=50, N=120) == 0.0
    small = sc.stress_inputs(n=100, F=20, epochs=2, batch_size=32)
    assert sc.check_stress_training("cpu", small) == (0.0, 0.0)
    config = load_yaml("configs/quickstart.yaml")
    config.update(model_type="fusion_moddrop", params={
        "hidden_dims": [8], "dropout": 0.2, "lr": 0.01, "batch_size": 32, "epochs": 3,
        "moddrop_rate": 0.3})
    data_config = load_yaml("configs/data_ppmi.yaml")
    eval_config = load_yaml("configs/eval_missingness.yaml")
    run_multi_seed_cv(dict(config), data_config, eval_config, seeds=[3, 4], k=5, synthetic=True,
                      sweep_dir=tmp_path)
    gaps = sc.standalone_gaps(config, data_config, eval_config, [3, 4], 5, tmp_path)
    assert set(gaps) == {3, 4} and max(gaps.values()) <= 1e-6
