"""The port's CLI under ``torchrun`` on the CPU: a gloo world of 4 ranks
against the port's one-process run and the JAX package's meshed run, a
world of 1 against the plain run, and the backend rule.

The runs are ``configs/quickstart.yaml --synthetic`` (N=500) with
``tests/test_multichip.py``'s overrides (hidden [16], 10 epochs; the
device GBDT at 12 trees, depth 3), at ``--k-fold 2``, so that 4 ranks form
a (2x2) mesh and both axes are live. The MLP families consume the JAX
package's draws: the one-process port run takes them from
``use_jax_draws`` and records them by key, and the ranks replay that
record (they import nothing of JAX). The JAX runs shard over this
process's 8 virtual devices (``cv_mesh: auto``). Bands, per fold,
``tests/test_multichip.py``'s: every full-observation probability within
5e-3 (calibrated ``fusion_moddrop`` 2e-2), every metric of every scenario
within 5e-2. Measured (printed): against the one-process run, probabilities
within 1.8e-07 and metrics within 1.8e-03 (the GBDT's: a rank metric steps
when a near-tie of 1e-07 flips); against the JAX run, probabilities within
1.1e-03 (the JAX draws through 10 epochs) and metrics within 1.6e-03.
"""
import datetime
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_multichip import run_world, torchrun_env  # noqa: E402

K = 2
MLP = {"hidden_dims": [16], "dropout": 0.1, "lr": 0.01, "batch_size": 32, "epochs": 10,
       "moddrop_rate": 0.3}
FAMILIES = {
    "fusion_moddrop": ({"model_type": "fusion_moddrop", "params": MLP}, 5e-3),
    "unimodal_gbdt": ({"model_type": "unimodal_gbdt",
                       "params": {"backend": "device", "n_estimators": 12, "max_depth": 3,
                                  "learning_rate": 0.1}}, 5e-3),
    "fusion_moddrop_calibrated": ({"model_type": "fusion_moddrop", "params": MLP,
                                   "calibrate": True, "nested_calibration": False,
                                   "calibration_split": 0.25}, 2e-2),
}
METRIC_BAND = 5e-2
# N=502: folds of 251 rows, which 2 does not divide, so 4 ranks form a
# (2x1) mesh and ranks 2 and 3, past it, receive the trained folds
RAGGED = {"ragged_moddrop": "fusion_moddrop", "ragged_gbdt": "unimodal_gbdt"}


# ---------------------------------------------------------------------------
# the JAX draws, recorded by key and replayed in the ranks
# ---------------------------------------------------------------------------


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    return x


def _torch(x, device):
    if isinstance(x, np.ndarray):
        return torch.tensor(x, device=device)
    if isinstance(x, (list, tuple)):
        return type(x)(_torch(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _torch(v, device) for k, v in x.items()}
    return x


def _seams():
    from pd_fusion_torch.experiments import run_experiment as TR
    from pd_fusion_torch.nn import mlp as TM
    from pd_fusion_torch.nn import trainer as TT
    from pd_fusion_torch.parallel import cv_engine

    return TR, TM, TT, cv_engine


def record_jax_draws(monkeypatch):
    """``use_jax_draws``, with the CV engine's keys numbered from each
    ``set_seed`` on and every init and draw kept under its key's number."""
    from test_torch_port_jax_draws import use_jax_draws

    use_jax_draws(monkeypatch)
    TR, TM, TT, cv_engine = _seams()
    table, count = {}, [0]
    key = cv_engine.fresh_generator

    def numbered(device=None):
        k = key(device)
        k.index, count[0] = count[0], count[0] + 1
        return k

    seed = TR.set_seed

    def reseed(s=42):
        count[0] = 0
        seed(s)

    monkeypatch.setattr(cv_engine, "fresh_generator", numbered)
    monkeypatch.setattr(TR, "set_seed", reseed)
    for mod, name in ((TM, "mlp_init"), (TT, "draw_minibatch"), (TT, "draw_fullbatch")):
        def rec(g, *a, _fn=getattr(mod, name), _name=name, **kw):
            out = _fn(g, *a, **kw)
            table[_draw_key(_name, g, a)] = _numpy(out)
            return out

        monkeypatch.setattr(mod, name, rec)
    return table


class _Key:
    def __init__(self, index):
        self.index = index


def _draw_key(name, key, args):
    """A draw's place in the table: the key's number and the draw's shapes
    (every argument but the device)."""
    return name, key.index, repr([a for a in args if not isinstance(a, (str, torch.device))
                                  and a is not None][:8])


def replay_draws(table):
    """In a rank: the CV engine's keys numbered as ``record_jax_draws``
    numbered them, each init and draw the recorded one."""
    TR, TM, TT, cv_engine = _seams()
    count = [0]
    seed = TR.set_seed

    def reseed(s=42):
        count[0] = 0
        seed(s)

    def key(device=None):
        count[0] += 1
        return _Key(count[0] - 1)

    TR.set_seed, cv_engine.fresh_generator = reseed, key
    TM.mlp_init = lambda g, dims, device=None: _torch(
        table[_draw_key("mlp_init", g, (dims,))], device)
    TT.draw_minibatch = lambda g, *a: _torch(table[_draw_key("draw_minibatch", g, a)], a[-1])
    TT.draw_fullbatch = lambda g, *a: _torch(table[_draw_key("draw_fullbatch", g, a)], a[-1])


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _rank_main(spec_path):
    """Every run of the spec through ``cli.main`` in one process group;
    each rank logs what it wrote and the run ids it used."""
    import pandas as pd

    from pd_fusion_torch import cli, paths
    from pd_fusion_torch.parallel import distributed

    spec = json.loads(Path(spec_path).read_text())
    out = Path(spec["out"])
    TR, _, _, cv_engine = _seams()
    calls = {"all_reduce": 0, "all_gather": 0, "broadcast": 0, "new_group": 0}
    for name in calls:
        def counted(*a, _fn=getattr(torch.distributed, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        setattr(torch.distributed, name, counted)
    with distributed.process_group():
        me = distributed.rank()
        writes, run_ids = [], []
        for mod, name in ((TR, "save_yaml"), (TR, "save_pickle"), (TR, "_example_plots"),
                          (TR, "get_run_dir"), (pd.DataFrame, "to_csv"),
                          (pd.DataFrame, "to_latex")):
            def logged(*a, _fn=getattr(mod, name), _name=name, **kw):
                writes.append(_name)
                return _fn(*a, **kw)

            setattr(mod, name, logged)
        run_dir = TR._run_dir

        def logged_dir(run_id):
            run_ids.append(run_id)
            return run_dir(run_id)

        TR._run_dir = logged_dir
        results, engine = [], cv_engine.run_parallel_cv

        def kept(*a, **kw):  # every rank's CV results, written or not
            metrics, preds = engine(*a, **kw)
            results.append({"metrics": json.loads(json.dumps(metrics)),
                            "probs": [p.tolist() for _, p in preds]})
            return metrics, preds

        cv_engine.run_parallel_cv = kept
        if spec.get("draws"):
            replay_draws(pickle.loads(Path(spec["draws"]).read_bytes()))
        # each rank's clock a second apart: the run id must still be rank 0's
        now = datetime.datetime(2026, 1, 1, 0, 0, me)
        TR.datetime = type("clock", (), {"datetime": type(
            "dt", (), {"now": staticmethod(lambda: now)})})
        paths.RUNS_DIR = out / "runs"
        for args in spec["runs"]:
            cli.main(args)
        (out / f"rank{me}.json").write_text(json.dumps(
            {"writes": writes, "run_ids": run_ids, "calls": calls, "results": results,
             "jax_modules": sorted(m for m in sys.modules if m in ("jax", "pd_fusion")
                                   or m.startswith(("jax.", "jaxlib", "pd_fusion.")))}))


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------


def _config(tmp: Path, name: str, extra: dict) -> str:
    cfg = yaml.safe_load((REPO / "configs/quickstart.yaml").read_text())
    cfg.update(extra)
    path = tmp / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _cli_args(config, out):
    return ["run", "--config", config, "--synthetic", "--k-fold", str(K), "--output-dir", str(out)]


def _results(out: Path):
    import pandas as pd

    folds = [yaml.safe_load((out / f"results_fold_{i}.yaml").read_text()) for i in range(1, K + 1)]
    probs = [pd.read_csv(out / f"preds_fold_{i}_full_observation.csv") for i in range(1, K + 1)]
    return folds, probs


def _gaps(a, b):
    """(max |prob diff|, max |metric diff|) of two runs; their labels equal."""
    (fa, pa), (fb, pb) = a, b
    for x, y in zip(pa, pb):
        assert (x["y_true"].values == y["y_true"].values).all()
    p = max(float(np.abs(x["y_prob"].values - y["y_prob"].values).max()) for x, y in zip(pa, pb))
    m = max(abs(f1[s][k] - f2[s][k]) for f1, f2 in zip(fa, fb) for s in f1 if s != "fold"
            for k in f1[s])
    return p, m


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from pd_fusion.experiments import run_experiment as JR
    from pd_fusion_torch import cli
    from test_torch_port_jax_draws import one_cpu_thread

    tmp = tmp_path_factory.mktemp("multichip_cli")
    mp = pytest.MonkeyPatch()
    mp.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    for var in ("PD_FUSION_HOST_ISOTONIC", "PD_FUSION_GBDT_BACKEND", "PD_FUSION_GBDT_HIST"):
        mp.delenv(var, raising=False)
    configs = {name: _config(tmp, name, extra) for name, (extra, _) in FAMILIES.items()}
    data_cfg = yaml.safe_load((REPO / "configs/data_ppmi.yaml").read_text())
    data_cfg["synthetic"]["num_samples"] = 502
    (tmp / "data502.yaml").write_text(yaml.safe_dump(data_cfg))
    for name, family in RAGGED.items():
        configs[name] = _config(tmp, name, dict(FAMILIES[family][0],
                                                data_config=str(tmp / "data502.yaml")))
    try:
        with one_cpu_thread():
            for name in FAMILIES:
                JR.run_cv_pipeline(configs[name], k=K, synthetic=True,
                                   overrides={"output_dir": str(tmp / f"jax_{name}")})
            # the plain one-process run, for the world of 1
            cli.main(_cli_args(configs["fusion_moddrop"], tmp / "plain"))
            table = record_jax_draws(mp)
            for name, config in configs.items():
                cli.main(_cli_args(config, tmp / f"one_{name}"))
    finally:
        mp.undo()
    (tmp / "draws.pkl").write_bytes(pickle.dumps(table))
    w4 = [_cli_args(config, tmp / f"w4_{name}") for name, config in configs.items()]
    w4.append(["run", "--config", configs["unimodal_gbdt"], "--synthetic", "--k-fold", str(K)])
    specs = {"w4": {"out": str(tmp / "w4"), "runs": w4, "draws": str(tmp / "draws.pkl")},
             "w1": {"out": str(tmp / "w1"),
                    "runs": [_cli_args(configs["fusion_moddrop"], tmp / "w1_plain")]}}
    for n, key in ((4, "w4"), (1, "w1")):
        Path(specs[key]["out"]).mkdir()
        (tmp / f"{key}.json").write_text(json.dumps(specs[key]))
        run_world(n, [__file__, tmp / f"{key}.json"], torchrun_env())
    ranks = {key: [json.loads((tmp / key / f"rank{r}.json").read_text()) for r in range(n)]
             for n, key in ((4, "w4"), (1, "w1"))}
    return {"tmp": tmp, "ranks": ranks}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_cli_at_world_4_matches_one_process_and_the_jax_meshed_run(runs, family):
    tmp, band = runs["tmp"], FAMILIES[family][1]
    got = _results(tmp / f"w4_{family}")
    for ref in ("one", "jax"):
        p, m = _gaps(got, _results(tmp / f"{ref}_{family}"))
        print(f"{family} world 4 against {ref}: max |prob diff| {p:.3e}, max |metric diff| "
              f"{m:.3e}")
        assert p < band and m < METRIC_BAND, (ref, p, m)
    prov = yaml.safe_load((tmp / f"w4_{family}" / "provenance.yaml").read_text())["env"]
    assert (prov["world_size"], prov["dist_backend"]) == (4, "gloo")


@pytest.mark.parametrize("name", list(RAGGED))
def test_ranks_past_a_ragged_mesh_receive_the_trained_folds(runs, name):
    """N=502: a (2x1) mesh of ranks 0-1; ranks 2-3 receive the trained folds
    by broadcast and hold every result of rank 0, bit for bit."""
    tmp, ranks = runs["tmp"], runs["ranks"]["w4"]
    i = len(FAMILIES) + list(RAGGED).index(name)
    assert all(r["results"][i] == ranks[0]["results"][i] for r in ranks[1:])
    p, m = _gaps(_results(tmp / f"w4_{name}"), _results(tmp / f"one_{name}"))
    print(f"{name} world 4 ((2x1) mesh) against one process: max |prob diff| {p:.3e}, max "
          f"|metric diff| {m:.3e}")
    assert p < 5e-3 and m < METRIC_BAND


def test_every_rank_holds_rank_0s_results(runs):
    ranks = runs["ranks"]["w4"]
    assert len(ranks[0]["results"]) == len(FAMILIES) + len(RAGGED) + 1
    assert all(r["results"] == ranks[0]["results"] for r in ranks[1:])


def test_cli_at_world_4_writes_the_run_once_on_rank_0(runs):
    tmp, ranks = runs["tmp"], runs["ranks"]["w4"]
    assert all(r["writes"] == [] for r in ranks[1:]), [r["writes"] for r in ranks]
    assert {"save_yaml", "to_csv", "get_run_dir"} <= set(ranks[0]["writes"])
    for family in list(FAMILIES) + list(RAGGED):
        assert sorted(p.name for p in (tmp / f"w4_{family}").iterdir()) == sorted(
            p.name for p in (tmp / f"one_{family}").iterdir())


def test_cli_run_ids_agree_across_ranks(runs):
    """The ranks' clocks differ by a second each; the id without
    ``--output-dir`` is rank 0's on every rank, and only its directory
    exists."""
    ids = [r["run_ids"][-1] for r in runs["ranks"]["w4"]]
    assert ids == ["cv_20260101_000000"] * 4
    assert [p.name for p in (runs["tmp"] / "w4" / "runs").iterdir()] == ["cv_20260101_000000"]


def test_cli_at_world_1_under_torchrun_is_the_plain_run(runs):
    """No collective, no sub-group: the one-process code path, bit for bit."""
    tmp, (rank,) = runs["tmp"], runs["ranks"]["w1"]
    assert rank["calls"] == {"all_reduce": 0, "all_gather": 0, "broadcast": 0, "new_group": 0}
    (fa, pa), (fb, pb) = _results(tmp / "w1_plain"), _results(tmp / "plain")
    assert fa == fb
    for x, y in zip(pa, pb):
        assert x.equals(y)
    prov = yaml.safe_load((tmp / "w1_plain" / "provenance.yaml").read_text())["env"]
    assert (prov["world_size"], prov["dist_backend"]) == (1, "gloo")


def test_ranks_import_nothing_of_jax(runs):
    for key in ("w4", "w1"):
        assert all(r["jax_modules"] == [] for r in runs["ranks"][key])


# ---------------------------------------------------------------------------
# the backend rule, in this process
# ---------------------------------------------------------------------------


@pytest.fixture
def launch_env(monkeypatch):
    from pd_fusion_torch.parallel import distributed

    for var in (distributed.BACKEND_ENV, "LOCAL_WORLD_SIZE", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    return distributed


@pytest.mark.parametrize("device,asked,n_cards,local_world,want", [
    ("cpu", None, 0, 4, "gloo"),
    ("cpu", "gloo", 0, 4, "gloo"),
    ("cuda:0", None, 2, 2, "nccl"),
    ("cuda:0", "gloo", 1, 2, "gloo"),
    ("cuda:0", "GLOO", 1, 3, "gloo"),
    ("cpu", "nccl", 0, 1, "a CUDA device"),
    ("cuda:0", "nccl", 0, 1, "a CUDA device"),
    ("cuda:0", None, 1, 2, "2 local ranks and 1 card"),
    ("cuda:1", "nccl", 2, 4, "4 local ranks and 2 card"),
    ("cpu", "mpi", 0, 1, "use 'nccl' or 'gloo'"),
])
def test_backend_rule(monkeypatch, launch_env, device, asked, n_cards, local_world, want):
    """NCCL with a card per local rank, gloo on the CPU or when asked for;
    NCCL with no card or with more local ranks than cards raises and names
    the variable, never switching the backend itself."""
    distributed = launch_env
    if asked is not None:
        monkeypatch.setenv(distributed.BACKEND_ENV, asked)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n_cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    if want in ("gloo", "nccl"):
        assert distributed.resolve_backend(torch.device(device)) == want
        return
    with pytest.raises((RuntimeError, ValueError), match=want) as err:
        distributed.resolve_backend(torch.device(device))
    if asked != "mpi":
        assert f"{distributed.BACKEND_ENV}=gloo" in str(err.value)


def test_setup_without_a_launcher_does_nothing(launch_env):
    distributed = launch_env
    assert not distributed.launched() and distributed.setup() is False
    assert not distributed.initialized() and distributed.world_size() == 1
    with distributed.process_group(kernels=True, host=True):
        assert not distributed.initialized()


@pytest.mark.parametrize("local_rank,n_cards,want", [(0, 1, 0), (1, 1, 0), (3, 2, 1), (2, 8, 2)])
def test_a_ranks_card_is_its_local_rank_modulo_the_cards(monkeypatch, launch_env, local_rank,
                                                          n_cards, want):
    from pd_fusion_torch.utils.device import DEVICE_ENV, get_device

    monkeypatch.delenv(DEVICE_ENV, raising=False)
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    assert get_device() == torch.device("cuda", want)
    assert get_device("cuda") == torch.device("cuda", want)
    assert get_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=f"{DEVICE_ENV}=cpu"):
        get_device()


if __name__ == "__main__":
    _rank_main(sys.argv[1])
