"""The port's CNN3D autoencoder (``nn/cnn3d.py``), its builder script and the
``cnn3d`` feature mode against the JAX package's, on the same seeded
numpy volumes (CPU, small: 16^3, embedding 8).

Tolerances:
- the weight gradients written as matrix products (``_Conv3x3``,
  ``_Deconv2``) against torch's autograd of the plain ops, float64: 1e-12;
- the forward from ``params_from_jax``: reconstruction and embeddings
  within 1e-5 (float32 convolutions summed in other orders);
- the loss gradient within 1e-4 of each leaf's largest magnitude;
- training fed the JAX package's permutations (3 epochs, N=6, batch 4, so
  that each epoch's second batch is padded): weights within 1e-5 absolute
  (1% of the learning rate, a float32 Adam step being about +-lr a
  weight) and embeddings within 1e-4 of their largest magnitude (measured:
  1.1e-6 and 2e-5);
- the builder script's artifacts: the JAX script's file names, columns and
  meta JSON for the same flags; each package's loader reads the port's
  parquet to the same frame and masks.
"""
import importlib.util
import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from pd_fusion.data import openneuro_features as JF
from pd_fusion.data.openneuro_ds001907 import load_openneuro_ds001907 as jax_load
from pd_fusion.experiments import run_experiment as JR
from pd_fusion.nn import cnn3d as J
from pd_fusion_torch.data.openneuro_ds001907 import load_openneuro_ds001907 as port_load
from pd_fusion_torch.imaging.nifti import write_nifti
from pd_fusion_torch.nn import cnn3d as T
from pd_fusion_torch.paths import ROOT_DIR
from test_torch_port_jax_draws import one_cpu_thread

SHAPE, EMB = (16, 16, 16), 8


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    with one_cpu_thread():
        yield


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, J.cnn3d_init(jax.random.PRNGKey(0), SHAPE, EMB))


def _vols(n=6, seed=0):
    return np.random.RandomState(seed).rand(n, *SHAPE).astype(np.float32)


def test_ae_enc_shape_and_init_shapes():
    assert T.ae_enc_shape((64, 64, 64)) == J.ae_enc_shape((64, 64, 64)) == (8, 8, 8, 32)
    assert T.ae_enc_shape((20, 18, 17)) == J.ae_enc_shape((20, 18, 17))
    jp = J.cnn3d_init(jax.random.PRNGKey(0), (24, 16, 32), 12)
    tp = T.cnn3d_init(torch.Generator().manual_seed(0), (24, 16, 32), 12)
    ported = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    fan_in = {"enc1": 27, "enc2": 27 * 8, "enc3": 27 * 16, "fc": 3 * 2 * 4 * 32, "fc_dec": 12,
              "dec1": 8 * 32, "dec2": 8 * 16, "dec3": 8 * 8}
    for name in T.LAYERS:
        bound = np.sqrt(1.0 / fan_in[name])  # uniform(+-bound), the JAX package's law
        for k in ("w", "b"):
            assert tp[name][k].shape == ported[name][k].shape, (name, k)
            for leaf in (np.asarray(jp[name][k]), tp[name][k].numpy()):
                assert np.abs(leaf).max() <= bound, (name, k)
                if leaf.size >= 16:  # and fills it
                    assert np.abs(leaf).max() > 0.5 * bound, (name, k)


def test_forward_matches_jax(jax_params):
    vols = _vols()
    tp = T.params_from_jax(jax_params)
    jr, je = J.cnn3d_apply(jax_params, jnp.asarray(vols[..., None]), SHAPE)
    tr, te = T.cnn3d_apply(tp, torch.from_numpy(vols[:, None]), SHAPE)
    assert tr.shape == (6, 1, *SHAPE) and te.shape == (6, EMB)
    np.testing.assert_allclose(tr[:, 0].detach().numpy(), np.asarray(jr)[..., 0], atol=1e-5)
    np.testing.assert_allclose(te.detach().numpy(), np.asarray(je), atol=1e-5)
    np.testing.assert_allclose(T.cnn3d_embed(tp, torch.from_numpy(vols[:, None]), SHAPE).numpy(),
                               np.asarray(J.cnn3d_embed(jax_params, jnp.asarray(vols[..., None]),
                                                        SHAPE)), atol=1e-5)


def test_transposed_convolutions_need_the_flipped_kernel(jax_params):
    """``lax.conv_transpose(transpose_kernel=False)`` is ``conv_transpose3d``
    of the spatially flipped kernel: without the flip the decoder differs."""
    vols = _vols()
    jr, _ = J.cnn3d_apply(jax_params, jnp.asarray(vols[..., None]), SHAPE)
    unflipped = T.params_from_jax(jax_params)
    for name in ("dec1", "dec2", "dec3"):
        unflipped[name]["w"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(jax_params[name]["w"]).transpose(3, 4, 0, 1, 2)))
    tr, _ = T.cnn3d_apply(unflipped, torch.from_numpy(vols[:, None]), SHAPE)
    assert np.abs(tr[:, 0].detach().numpy() - np.asarray(jr)[..., 0]).max() > 1e-3


def _jax_loss(p, x, w):
    recon, _ = J.cnn3d_apply(p, x, SHAPE)
    per = jnp.mean((recon - x) ** 2, axis=(1, 2, 3, 4))
    t = jnp.sum(w)
    return jnp.sum(per * w) / jnp.where(t > 0, t, 1.0)


@pytest.mark.parametrize("weights", [[1, 1, 1, 1, 1, 1], [1, 1, 1, 0, 1, 0], [0] * 6],
                         ids=["full", "padded", "all-padding"])
def test_loss_and_gradient_match_jax(jax_params, weights):
    vols = _vols()
    w = np.asarray(weights, np.float32)
    want_loss, want = jax.value_and_grad(_jax_loss)(jax_params, jnp.asarray(vols[..., None]),
                                                    jnp.asarray(w))
    want = T.params_from_jax(jax.tree_util.tree_map(np.asarray, want))
    flat = [p.detach().requires_grad_(True) for p in T.leaves(T.params_from_jax(jax_params))]
    loss = T.recon_loss(T.from_leaves(flat), torch.from_numpy(vols[:, None]), torch.from_numpy(w),
                        SHAPE)
    got = T.from_leaves(torch.autograd.grad(loss, flat))
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5, abs=1e-12)
    for name in T.LAYERS:
        for k in ("w", "b"):
            g, wt = got[name][k].numpy(), want[name][k].numpy()
            assert np.isfinite(g).all()
            scale = max(float(np.abs(wt).max()), 1e-30)
            np.testing.assert_allclose(g, wt, rtol=0, atol=1e-4 * scale, err_msg=f"{name}.{k}")


@pytest.mark.parametrize("layer", ["conv3x3", "deconv2"])
@pytest.mark.parametrize("cin,cout", [(1, 8), (4, 5), (3, 2)])
def test_weight_gradients_as_matrix_products_equal_autograd_of_the_plain_ops(layer, cin, cout):
    """``_Conv3x3``/``_Deconv2`` in float64: ``gradcheck``, and the input,
    weight and bias gradients of torch's own autograd through
    ``conv3d``/``conv_transpose3d`` to 1e-12."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(cin * 10 + cout)
    if layer == "conv3x3":
        fn, plain = T._Conv3x3.apply, lambda x, w, b: F.conv3d(x, w, b, padding=1)
        shapes = ((2, cin, 4, 3, 5), (cout, cin, 3, 3, 3), (cout,))
    else:
        fn, plain = T._Deconv2.apply, lambda x, w, b: F.conv_transpose3d(x, w, b, stride=2)
        shapes = ((2, cin, 3, 4, 2), (cin, cout, 2, 2, 2), (cout,))
    x, w, b = (torch.randn(s, generator=g, dtype=torch.float64).requires_grad_(True)
               for s in shapes)
    assert torch.autograd.gradcheck(fn, (x, w, b))
    y = fn(x, w, b)
    up = torch.randn(y.shape, generator=g, dtype=torch.float64)
    for got, want in zip(torch.autograd.grad(y, (x, w, b), up),
                         torch.autograd.grad(plain(x, w, b), (x, w, b), up)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_training_fed_the_jax_permutations_matches_jax(jax_params, monkeypatch):
    """3 epochs on N=6 at batch 4: the second batch of each epoch holds two
    volumes and two pads (index 0, weight 0)."""
    vols = _vols()
    key, epochs, bs, lr = jax.random.PRNGKey(1), 3, 4, 3e-3
    perms = [np.asarray(jax.random.permutation(k, 6)) for k in jax.random.split(key, epochs)]
    jt = jax.tree_util.tree_map(np.asarray, J.train_cnn3d(
        jax_params, jnp.asarray(vols[..., None]), key, lr, SHAPE, epochs, bs))
    steps = []
    step = T.train_step
    monkeypatch.setattr(T, "train_step", lambda *a: steps.append(a[3].tolist()) or step(*a))
    tt = T.train_cnn3d(T.params_from_jax(jax_params), torch.from_numpy(vols[:, None]), lr, SHAPE,
                       epochs, bs, perms=perms)
    assert steps == [[1.0] * 4, [1.0, 1.0, 0.0, 0.0]] * epochs  # each epoch's weights
    want = T.params_from_jax(jt)
    start = T.params_from_jax(jax_params)
    for name in T.LAYERS:
        for k in ("w", "b"):
            np.testing.assert_allclose(tt[name][k].numpy(), want[name][k].numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"{name}.{k}")
            assert float((want[name][k] - start[name][k]).abs().max()) > 1e-3  # it trained
    je = np.asarray(J.cnn3d_embed(jt, jnp.asarray(vols[..., None]), SHAPE))
    te = T.cnn3d_embed(tt, torch.from_numpy(vols[:, None]), SHAPE).numpy()
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-4 * np.abs(je).max())


def test_epoch_batches_pad_with_index_zero_at_weight_zero():
    idx, w = T.epoch_batches(torch.tensor([4, 2, 0, 5, 1, 3]), 4)
    assert idx.tolist() == [[4, 2, 0, 5], [1, 3, 0, 0]]
    assert w.tolist() == [[1, 1, 1, 1], [1, 1, 0, 0]]


def test_reconstruction_loss_falls_with_a_torch_generator():
    vols = torch.from_numpy(_vols())[:, None]
    params = T.cnn3d_init(torch.Generator().manual_seed(0), SHAPE, EMB)
    ones = torch.ones(6)
    before = float(T.recon_loss(params, vols, ones, SHAPE).detach())
    trained = T.train_cnn3d(params, vols, 3e-3, SHAPE, 15, 3,
                            generator=torch.Generator().manual_seed(1))
    after = float(T.recon_loss(trained, vols, ones, SHAPE).detach())
    assert after < before
    again = T.train_cnn3d(params, vols, 3e-3, SHAPE, 15, 3,
                          generator=torch.Generator().manual_seed(1))
    for a, b in zip(T.leaves(trained), T.leaves(again)):
        assert torch.equal(a, b)  # the generator fixes the run


# ---------------------------------------------------------------------------
# the builder script, the loader and the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """12 subjects x 2 sessions of int16 volumes; PD subjects carry a darker
    deep region."""
    root = tmp_path_factory.mktemp("cnn_ds")
    rng = np.random.RandomState(0)
    rows = []
    for s in range(12):
        label = s % 2
        for session in (1, 2):
            vol = rng.rand(22, 26, 20) * 150
            vol[2:20, 2:24, 2:18] += 600
            if label:
                vol[8:14, 9:15, 7:12] *= 0.7
            p = root / f"sub-{s:02d}_ses-{session}_T1w.nii.gz"
            write_nifti(p, np.round(vol / 0.5).astype(np.int16), scl_slope=0.5)
            rows.append({"subject_id": f"sub-{s:02d}", "session": session, "label": label,
                         "t1wbrain_path": str(p)})
    manifest = root / "manifest.csv"
    pd.DataFrame(rows).to_csv(manifest, index=False)
    return root, manifest, rows


FLAGS = ["--target-shape", "16", "16", "16", "--embedding-dim", "8", "--epochs", "2",
         "--batch-size", "4", "--lr", "0.003"]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_build_cnn3d_embeddings", ROOT_DIR / "scripts" / "build_cnn3d_embeddings.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_builder_script_writes_the_jax_scripts_artifacts(dataset, tmp_path, monkeypatch):
    from pd_fusion_torch.scripts import build_cnn3d_embeddings as script

    _, manifest, rows = dataset
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    out = script.main(["--manifest", str(manifest), "--out-dir", str(port_dir), *FLAGS])
    assert not out["cached"] and set(out["stages"]) == {"read_s", "init_s", "train_s", "embed_s",
                                                        "write_s"}
    monkeypatch.setattr(jax, "device_count", lambda: 1)  # the JAX script's one-device branch
    monkeypatch.setattr("sys.argv", ["build_cnn3d_embeddings.py", "--manifest", str(manifest),
                                     "--out-dir", str(jax_dir), *FLAGS])
    _jax_script().main()
    names = sorted(p.name for p in port_dir.iterdir())
    assert names == sorted(p.name for p in jax_dir.iterdir()) and len(names) == 2
    assert out["path"].name in names
    t_df, j_df = (pd.read_parquet(d / out["path"].name) for d in (port_dir, jax_dir))
    assert list(t_df.columns) == list(j_df.columns)
    assert list(t_df.columns) == [f"mri_cnn_{i}" for i in range(8)] + ["subject_id", "session",
                                                                       "label"]
    assert list(t_df.dtypes) == list(j_df.dtypes) and len(t_df) == len(rows)
    assert np.isfinite(t_df.filter(like="mri_cnn_").to_numpy()).all()
    meta = [json.loads((d / out["path"].with_suffix(".json").name).read_text())
            for d in (port_dir, jax_dir)]
    assert meta[0] == meta[1]
    # the stem is the one the loaders look up for the same five settings
    cfg = script.config_from_args(script.parse_args(["--manifest", str(manifest), *FLAGS]))
    assert out["path"].stem == JF._cache_stem("embeddings", manifest, cfg)
    assert script.main(["--manifest", str(manifest), "--out-dir", str(port_dir), *FLAGS])["cached"]


def _configs(tmp_path, manifest, mode, cache, cnn_cfg=None, feature_cfg=None, **overrides):
    """A copy of configs/openneuro_ds001907_simple.yaml whose data config
    points at ``manifest`` and ``cache`` with ``feature_mode: mode``."""
    cfg = yaml.safe_load((ROOT_DIR / "configs/openneuro_ds001907_simple.yaml").read_text())
    data_cfg = yaml.safe_load((ROOT_DIR / cfg["data_config"]).read_text())
    data_cfg.update(manifest_path=str(manifest), feature_mode=mode,
                    embedding_cache_dir=str(cache), feature_cache_dir=str(cache))
    if cnn_cfg is not None:
        data_cfg["cnn_config"] = cnn_cfg
    if feature_cfg is not None:
        data_cfg["feature_config"] = feature_cfg
    (tmp_path / f"data_{mode}.yaml").write_text(yaml.safe_dump(data_cfg))
    cfg.update(data_config=str(tmp_path / f"data_{mode}.yaml"), **overrides)
    path = tmp_path / f"{mode}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path, data_cfg


SMALL_MODDROP = {"hidden_dims": [12, 6], "dropout": 0.2, "lr": 0.02, "batch_size": 8,
                 "epochs": 4, "moddrop_rate": 0.3}


def _tree(d):
    return sorted(p.name for p in d.iterdir())


@pytest.mark.parametrize("mode", ["cnn3d", "simple"])
def test_feature_modes_through_both_loaders_and_clis(dataset, tmp_path, monkeypatch, mode):
    """The port's builder script (``cnn3d``) or the first load (``simple``),
    then both loaders give the same frame and masks, and the port's CLI and
    the JAX pipeline run the config's 2-fold CV to the same artifact files."""
    from pd_fusion_torch import cli
    from pd_fusion_torch.scripts import build_cnn3d_embeddings as script

    _, manifest, rows = dataset
    cache = tmp_path / "cache"
    if mode == "cnn3d":
        argv = ["--manifest", str(manifest), "--out-dir", str(cache), *FLAGS]
        script.main(argv)
        extra = {"cnn_cfg": script.config_from_args(script.parse_args(argv))}
    else:
        extra = {"feature_cfg": {"hist_bins": 10, "grid_size": 4, "target_shape": [16, 16, 16]}}
    config, data_cfg = _configs(tmp_path, manifest, mode, cache, params=SMALL_MODDROP,
                                cv_plot_example=False, calibration_split=0.5, **extra)
    got, masks = port_load(data_cfg)
    want, want_masks = jax_load(data_cfg)
    pd.testing.assert_frame_equal(got, want)
    for k in ("clinical", "datspect", "mri"):
        np.testing.assert_array_equal(masks[k], want_masks[k])
    prefix = "mri_cnn_" if mode == "cnn3d" else "mri_feat_"
    assert masks["mri"].sum() == len(rows) and sum(c.startswith(prefix) for c in got) > 0

    monkeypatch.setenv("PD_FUSION_HOST_ISOTONIC", "1")
    agg = cli.main(["run", "--config", str(config), "--k-fold", "2", "--output-dir",
                    str(tmp_path / "own")])
    assert len(agg) == 7 and np.isfinite(agg["full_observation"]["roc_auc"]["mean"])
    JR.run_cv_pipeline(str(config), k=2, overrides={"output_dir": str(tmp_path / "jax")})
    assert _tree(tmp_path / "own") == _tree(tmp_path / "jax")


def test_cnn3d_mode_without_the_artifact_names_the_ports_script(dataset, tmp_path):
    _, manifest, _ = dataset
    _, data_cfg = _configs(tmp_path, manifest, "cnn3d", tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="pd_fusion_torch.scripts.build_cnn3d_embeddings"):
        port_load(data_cfg)
