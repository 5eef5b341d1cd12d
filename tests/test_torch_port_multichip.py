"""The port's multi-device tier (``parallel/distributed.py``,
``parallel/dryrun.py`` and the sharded branches) in a gloo world of 4 CPU
ranks, against one rank and against the JAX package's sharded programs.

One world is spawned for the module (``python -m torch.distributed.run
--standalone``, so parallel workers never share a port; each rank on one
CPU thread): this file is also the ranks' script (``_rank_main``), which
imports nothing of JAX. The ranks run:

- the dry run at ``--size small`` on the (2x2), (1x4) and (4x1) meshes,
  each leg against rank 0's one-rank run, within the JAX dry run's
  tolerances (5e-4 on params and histogram sums, 2e-2 on the GBDT train
  AUC, 5e-5 on embeddings; measured (printed): 1.5e-08 to 4.2e-07 on the
  trainers' params, 3.8e-06 on the histogram sums, 7.3e-04 on the train
  AUC, 0 on the embeddings, 6.5e-05 on the MIL-FT step, where Adam's first
  step moves a weight whose gradient is rounding noise by up to 2 lr) and
  1e-9 on the MIL-FT step's float64 gradients, each leaf relative to its
  scale (measured 1.2e-14; an all-reduce without a backward in BN, the
  gradients averaged, or the head's left out of the sum give 0.75-1.7),
  with the data axis's replicas bitwise equal;
- the CV engine's minibatch ModDrop trainer on a (2x2) mesh fed the JAX
  package's draws (5 epochs), held to the JAX ``_train_folds_moddrop`` on
  its (2x4) mesh of 8 virtual devices within 5e-4 (measured: 2.7e-07);
- the embed pipeline (11 subjects, ``SUBJECTS_PER_CALL=8``, ``tta: 2``)
  with ``PD_FUSION_EMBED_MESH=1`` against ``=0``, within 5e-5;
- the CNN3D builder script, whose parquet (written by rank 0 alone) must
  equal the one-rank build's within 5e-4;
- the host IO library built once, by the first local rank, while the
  others wait.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
LEGS = {"moddrop": 5e-4, "fullbatch": 5e-4, "moe": 5e-4, "gbdt": 5e-4, "gbdt_auc": 2e-2, "mil_ft": 5e-4,
        "mil_ft_grads": 1e-9, "cnn3d": 5e-4, "embed": 5e-5}
MESHES = [(2, 2), (1, 4), (4, 1)]
K_T, N_T, F_T = 4, 256, 16  # the JAX dry run's moddrop frame at 8 devices
CNN_FLAGS = ["--target-shape", "16", "16", "16", "--embedding-dim", "8", "--epochs", "2",
             "--batch-size", "4"]


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _rank_main(spec_path):
    spec = json.loads(Path(spec_path).read_text())
    out = Path(spec["out"])
    from pd_fusion_torch.imaging import native
    from pd_fusion_torch.parallel import distributed, dryrun

    # a build directory of its own, so the first build is this world's
    native.HOST_BUILD_DIR = Path(spec["host_build_dir"])
    seen, real_build = [], native.build_library

    def build(source=native.SOURCE):
        seen.append(any(native.HOST_BUILD_DIR.glob("*.so")))
        return real_build(source)

    native.build_library = build
    with distributed.process_group(host=True):
        me = distributed.rank()
        res = {"rank": me, "world": distributed.world_size(), "backend": distributed.backend()}
        res["dryrun"] = dryrun.run("small", MESHES)
        res.update(_rank_helpers(distributed))
        _rank_trainer(spec, out, distributed)
        res["embed_max_diff"] = _rank_pipeline(spec)
        from pd_fusion_torch.scripts import build_cnn3d_embeddings

        res["cnn3d_script"] = str(build_cnn3d_embeddings.main(
            ["--manifest", spec["manifest"], "--out-dir", str(out / "cnn_w4"), *CNN_FLAGS])["path"])
        res["built_before_first_use"] = seen[:1]
        res["jax_modules"] = sorted(m for m in sys.modules if m in ("jax", "pd_fusion")
                                    or m.startswith(("jax.", "jaxlib", "pd_fusion.")))
        (out / f"rank{me}.json").write_text(json.dumps(res))


def _rank_helpers(distributed):
    """The collective helpers on ragged and typed inputs."""
    me, n = distributed.rank(), distributed.world_size()
    rows = distributed.gather_rows(torch.full((me + 1, 2), float(me)))
    want = torch.cat([torch.full((r + 1, 2), float(r)) for r in range(n)])
    grads = distributed.all_reduce_grads([torch.ones(2, 3) * me, torch.ones(4) * (me + 1)], None)
    flags = distributed.all_gather(torch.tensor([me % 2 == 0]))
    share = distributed.local_slice(10, n, me)
    return {
        "row_span_ok": distributed.row_span(share.stop - share.start, torch.distributed.group.WORLD) == (
            share.start, 10),
        "gather_rows_ok": torch.equal(rows, want),
        "all_reduce_grads_ok": (torch.equal(grads[0], torch.full((2, 3), n * (n - 1) / 2))
                                and torch.equal(grads[1], torch.full((4,), n * (n + 1) / 2))),
        "bool_gather_ok": [bool(f) for f in flags] == [r % 2 == 0 for r in range(n)],
        "broadcast_object": distributed.broadcast_object({"id": f"from rank {me}"}),
    }


def _rank_trainer(spec, out, distributed):
    """The minibatch ModDrop trainer on a (2x2) mesh, fed the JAX draws."""
    from pd_fusion_torch.nn.trainer import minibatch_moddrop_impl

    d = np.load(spec["trainer_npz"])
    mesh = distributed.fold_data_mesh(2, 2, "cpu")
    from pd_fusion_torch.parallel.cv_engine import _mesh_slices

    folds, rows = _mesh_slices(mesh, K_T, N_T)
    t = torch.as_tensor
    params = [{"w": t(d[f"w{i}"][folds]), "b": t(d[f"b{i}"][folds])} for i in range(2)]
    trained = minibatch_moddrop_impl(
        params, t(d["X"][folds, rows]), t(d["y"][folds, rows]), t(d["w"][folds, rows]),
        t(d["assign"]), None, 1e-3, 5, 32, 0.2, 0.0, 0.3, perms=t(d["perms"][folds]),
        moddrop_keep=t(d["mkeep"][folds]), dropout_keep=[t(d["dkeep"][folds])],
        data_group=mesh.data_group)
    flat = [trained[i][k] for i in range(2) for k in ("w", "b")]
    replicas = [distributed.all_gather(v, mesh.data_group) for v in flat]
    gathered = [distributed.gather_folds(v, mesh) for v in flat]
    if distributed.is_primary():
        np.savez(out / "trainer.npz", *[g.numpy() for g in gathered],
                 replicas_equal=all(torch.equal(r, v) for rs, v in zip(replicas, flat)
                                    for r in rs))


def _rank_pipeline(spec):
    """The embed pipeline, every rank on every subject and then each rank on
    its share."""
    from pd_fusion_torch.imaging import pipeline
    from pd_fusion_torch.nn.resnet import init_resnet

    params = init_resnet(torch.Generator().manual_seed(3), "resnet18")
    half = np.float32([0.5, 0.5, 0.5])
    kw = dict(arch="resnet18", target_shape=(16, 16, 16), axes=[2], counts=[4], input_size=32,
              per_slice=True, progress=False, tta=2)
    pipeline.SUBJECTS_PER_CALL = 8
    runs = {}
    for mesh in ("0", "1"):
        os.environ["PD_FUSION_EMBED_MESH"] = mesh
        runs[mesh] = pipeline.run_resnet_embedding_pipeline(spec["niftis"], spec["sids"], params,
                                                            half, half, **kw)
    assert len(runs["0"]) == len(runs["1"]) == len(spec["sids"])
    return max(float(np.abs(a - b).max()) for a, b in zip(runs["0"], runs["1"]))


# ---------------------------------------------------------------------------
# the world, spawned once
# ---------------------------------------------------------------------------


def _jax_trainer_case(tmp: Path):
    """The JAX dry run's moddrop frame (K=4, N=256) trained on its (2x4)
    mesh of 8 virtual devices, and its inputs and draws for the ranks."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from pd_fusion.nn.mlp import mlp_init
    from pd_fusion.parallel.cv_engine import _stack_params, _train_folds_moddrop
    from test_torch_port_jax_draws import minibatch_draws

    assign = np.zeros((F_T, 3), np.float32)
    assign[:6, 0] = assign[6:10, 1] = assign[10:, 2] = 1.0
    rng = np.random.RandomState(0)
    X = rng.randn(K_T, N_T, F_T).astype(np.float32)
    y = rng.randint(0, 2, (K_T, N_T)).astype(np.float32)
    w = np.ones((K_T, N_T), np.float32)
    params = _stack_params([mlp_init(jax.random.PRNGKey(i), [F_T, 32, 1]) for i in range(K_T)])
    keys = [jax.random.PRNGKey(100 + i) for i in range(K_T)]
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("fold", "data"))
    kn, k_ = NamedSharding(mesh, P("fold", "data")), NamedSharding(mesh, P("fold"))
    with mesh:
        trained = _train_folds_moddrop(
            jax.tree_util.tree_map(lambda a: jax.device_put(a, k_), params),
            jax.device_put(X, kn), jax.device_put(y, kn), jax.device_put(w, kn),
            jax.device_put(jnp.asarray(assign), NamedSharding(mesh, P())),
            jax.device_put(jnp.stack(keys), k_), 1e-3, 5, 32, 0.2, 0.0, 0.3)
    draws = [minibatch_draws(k, 5, N_T, 32, 3, [32], 0.2, 0.3, False) for k in keys]
    np.savez(tmp / "trainer_in.npz", X=X, y=y, w=w, assign=assign,
             perms=np.stack([d[0] for d in draws]), mkeep=np.stack([d[1] for d in draws]),
             dkeep=np.stack([d[2][0] for d in draws]),
             **{f"{k}{i}": np.asarray(params[i][k]) for i in range(2) for k in ("w", "b")})
    return [np.asarray(trained[i][k]) for i in range(2) for k in ("w", "b")]


def _volumes(tmp: Path):
    from pd_fusion_torch.imaging.nifti import write_nifti

    rng = np.random.RandomState(7)
    rows = []
    for i in range(11):
        p = tmp / f"sub{i}.nii.gz"
        write_nifti(str(p), (rng.rand(12, 10, 8) * 900).astype(np.int16))
        rows.append({"subject_id": f"s{i}", "session": 1 + i % 2, "label": i % 2,
                     "t1wbrain_path": str(p)})
    import pandas as pd

    pd.DataFrame(rows).to_csv(tmp / "manifest.csv", index=False)
    return [r["t1wbrain_path"] for r in rows], [r["subject_id"] for r in rows]


def torchrun_env(**extra):
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO / 'tests'}",
               PD_FUSION_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
               PD_FUSION_TORCH_DIST_TIMEOUT="240", **extra)
    env.pop("PD_FUSION_TORCH_DIST_BACKEND", None)
    return env


def run_world(nproc, args, env, timeout=400):
    """``python -m torch.distributed.run --standalone`` (a free port of its
    own) with ``args``; fails the test with the ranks' output."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}", *map(str, args)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    return proc


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from test_torch_port_jax_draws import one_cpu_thread

    tmp = tmp_path_factory.mktemp("multichip")
    with one_cpu_thread():
        jax_trained = _jax_trainer_case(tmp)
        niftis, sids = _volumes(tmp)
        spec = {"out": str(tmp), "trainer_npz": str(tmp / "trainer_in.npz"), "niftis": niftis,
                "sids": sids, "manifest": str(tmp / "manifest.csv"),
                "host_build_dir": str(tmp / "host_build")}
        (tmp / "spec.json").write_text(json.dumps(spec))
        proc = run_world(WORLD, [__file__, tmp / "spec.json"], torchrun_env())
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(WORLD)]
        # the same CNN3D build at world 1, in this process
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
            from pd_fusion_torch.scripts import build_cnn3d_embeddings

            one = build_cnn3d_embeddings.main(["--manifest", spec["manifest"], "--out-dir",
                                               str(tmp / "cnn_w1"), *CNN_FLAGS])["path"]
    return {"tmp": tmp, "ranks": ranks, "stdout": proc.stdout, "jax_trained": jax_trained,
            "cnn_w1": one}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world_size", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("n", [64, 63, 250])
@pytest.mark.parametrize("k", [2, 3, 4, 5, 10])
def test_cv_mesh_shape_is_the_jax_rule(monkeypatch, k, n, world_size):
    """The port's (fold, data) split is the JAX ``_cv_mesh``'s, run with
    ``jax.device_count`` patched to the world size."""
    import jax

    from pd_fusion.parallel import cv_engine as JC
    from pd_fusion_torch.parallel.cv_engine import _cv_mesh_shape

    devices = jax.devices()[:world_size]
    monkeypatch.setattr(jax, "device_count", lambda: world_size)
    monkeypatch.setattr(jax, "devices", lambda: devices)
    mesh = JC._cv_mesh(k, n)
    want = None if mesh is None else tuple(mesh.devices.shape)
    assert _cv_mesh_shape(k, n, world_size) == want


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_dryrun_leg_within_the_jax_dry_runs_tolerance(world, leg):
    print(f"dry run {leg}: max |diff| {world['ranks'][0]['dryrun']['diffs'][leg]:.3e}")
    for r in world["ranks"]:
        assert r["dryrun"]["diffs"][leg] <= LEGS[leg], (leg, r["dryrun"]["diffs"])
    assert "dryrun_multichip OK: mesh=(2x2)+(1x4)+(4x1)" in world["stdout"]


def test_dryrun_data_axis_replicas_are_bitwise_equal(world):
    rep = world["ranks"][0]["dryrun"]["replicas_equal"]
    assert len(rep) == 3 * 5 + 2 and all(rep.values()), rep


def test_sharded_trainer_fed_the_jax_draws_matches_the_jax_mesh(world):
    with np.load(world["tmp"] / "trainer.npz") as got:
        assert bool(got["replicas_equal"])
        worst = max(float(np.abs(got[f"arr_{i}"] - want).max())
                    for i, want in enumerate(world["jax_trained"]))
    print(f"sharded trainer (2x2 gloo) against the JAX (2x4) mesh: max |diff| {worst:.3e}")
    assert worst <= 5e-4, worst


def test_embed_pipeline_meshed_equals_every_rank_whole(world):
    print(f"embed pipeline meshed against whole: max |diff| {world['ranks'][0]['embed_max_diff']:.3e}")
    for r in world["ranks"]:
        assert r["embed_max_diff"] <= 5e-5, r["embed_max_diff"]


def test_cnn3d_script_at_world_4_equals_world_1_written_once(world):
    import pandas as pd

    paths = {r["cnn3d_script"] for r in world["ranks"]}
    assert len(paths) == 1 and Path(paths.pop()).name == Path(world["cnn_w1"]).name
    files = sorted(p.name for p in (world["tmp"] / "cnn_w4").iterdir())
    assert files == sorted(p.name for p in Path(world["cnn_w1"]).parent.iterdir())
    a = pd.read_parquet(world["cnn_w1"])
    b = pd.read_parquet(world["tmp"] / "cnn_w4" / Path(world["cnn_w1"]).name)
    assert list(a.columns) == list(b.columns) and a["subject_id"].tolist() == b[
        "subject_id"].tolist()
    emb = [c for c in a.columns if c.startswith("mri_cnn_")]
    worst = np.abs(a[emb].to_numpy() - b[emb].to_numpy()).max()
    print(f"CNN3D script world 4 against world 1: max |emb diff| {worst:.3e}")
    assert worst <= 5e-4


def test_native_library_is_built_by_the_first_rank_while_the_others_wait(world):
    seen = {r["rank"]: r["built_before_first_use"] for r in world["ranks"]}
    assert seen[0] == [False]  # rank 0 built it
    assert all(seen[r] == [True] for r in range(1, WORLD))  # the others found it built


def test_collective_helpers_and_the_ranks_imports(world):
    for r in world["ranks"]:
        assert (r["world"], r["backend"]) == (WORLD, "gloo")
        assert r["gather_rows_ok"] and r["all_reduce_grads_ok"] and r["bool_gather_ok"]
        assert r["row_span_ok"]
        assert r["broadcast_object"] == {"id": "from rank 0"}
        assert r["jax_modules"] == []


def test_mesh_and_helpers_without_a_process_group(monkeypatch):
    """One process, no launcher: world 1, no mesh, every helper the
    identity, no collective called."""
    from pd_fusion_torch.parallel import cv_engine, distributed
    from pd_fusion_torch.utils.device import make_data_mesh, shard_rows

    for name in ("all_reduce", "all_gather", "broadcast", "new_group"):
        monkeypatch.setattr(torch.distributed, name, lambda *a, **k: pytest.fail("called"))
    x = torch.arange(6.0)
    assert distributed.world_size() == 1 and distributed.is_primary()
    assert cv_engine._cv_mesh(5, 400) is None and make_data_mesh() is None
    assert shard_rows(x, None) is x
    assert distributed.all_reduce(x) is x and distributed.gather_rows(x) is x
    assert distributed.broadcast_object("run") == "run"
    assert distributed.row_span(7, None) == (0, 7)
    assert [distributed.local_slice(10, 4, i) for i in range(4)] == [
        slice(0, 3), slice(3, 6), slice(6, 8), slice(8, 10)]


if __name__ == "__main__":
    _rank_main(sys.argv[1])
