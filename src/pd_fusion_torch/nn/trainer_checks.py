"""The fold-batched tabular trainer on the card against the same trainer on
the CPU, fed the same explicit draws (``nn/trainer.py``'s seam), shared
by ``chip_smoke.py`` and ``tests/test_torch_port_cuda.py``.

Matmuls run in full float32 on the card (``utils/device.py`` turns TF32
off), so the two runs differ only in the order of floating-point sums.
Adam normalises every update by its own gradient scale, so a rounding
difference in a near-zero gradient could move a weight by up to ``lr`` in
one step. On an H100 the bench frame's 650 steps stayed within 4.5e-7 on
the params and 1.8e-7 on the probabilities (PERF.md); the full-run
tolerance keeps a 200x margin over that.

``quickstart_auc_draws`` is the quickstart's ROC-AUC over many generator
chains, which ``chip_smoke.py`` and the CPU tests hold to the JAX
package's.
"""
import time

import numpy as np
import torch

from pd_fusion_torch.nn.mlp import mlp_apply, mlp_init
from pd_fusion_torch.nn.trainer import draw_minibatch, minibatch_moddrop_impl

# (params, probabilities) max abs error allowed between card and CPU
SHORT_ATOL = (1e-5, 1e-5)  # 2 epochs
FULL_ATOL = (1e-4, 1e-4)  # a full run (e.g. 50 epochs x 13 batches)
MODALITY_DIMS = (10, 5, 20)  # the synthetic PPMI frame's clinical / datspect / mri widths


def trainer_inputs(K=5, n=400, hidden=(64, 32), epochs=50, batch_size=32, dropout=0.2,
                   moddrop_rate=0.3, per_sample=False, seed=0):
    """CPU tensors for one fold-batched run: stacked params, data with the
    last fold ragged (weight-0 padding rows), the assignment matrix and the
    draws (one CPU generator per fold)."""
    F = sum(MODALITY_DIMS)
    rng = np.random.RandomState(seed)
    X = rng.randn(K, n, F).astype(np.float32)
    y = (X[..., 0] - X[..., 10] + 0.5 * rng.randn(K, n) > 0).astype(np.float32)
    w = np.ones((K, n), np.float32)
    w[-1, -(n // 10):] = 0.0
    assign = np.zeros((F, 3), np.float32)
    start = 0
    for m, d in enumerate(MODALITY_DIMS):
        assign[start:start + d, m] = 1.0
        start += d
    per_fold = [mlp_init(torch.Generator().manual_seed(seed * 100 + k), [F, *hidden, 1])
                for k in range(K)]
    params = [{k: torch.stack([p[li][k] for p in per_fold]) for k in ("w", "b")}
              for li in range(len(hidden) + 1)]
    draws = [draw_minibatch(torch.Generator().manual_seed(seed * 100 + 50 + k), epochs, n,
                            batch_size, 3, list(hidden), dropout, moddrop_rate, per_sample, "cpu")
             for k in range(K)]
    perms = torch.stack([d[0] for d in draws])
    mkeep = torch.stack([d[1] for d in draws])
    dkeep = None if dropout <= 0 else [torch.stack(l) for l in zip(*[d[2] for d in draws])]
    return {"params": params, "X": torch.from_numpy(X), "y": torch.from_numpy(y),
            "w": torch.from_numpy(w), "assign": torch.from_numpy(assign), "perms": perms,
            "moddrop_keep": mkeep, "dropout_keep": dkeep,
            "hp": {"epochs": epochs, "batch_size": batch_size, "dropout": dropout,
                   "moddrop_rate": moddrop_rate, "per_sample": per_sample}}


def _to(x, device):
    if x is None:
        return None
    if isinstance(x, list):
        return [_to(v, device) for v in x]
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return x.to(device)


def run_trainer(inputs, device, lr=1e-3, weight_decay=0.0):
    """-> (trained params on the CPU, probs [K, n] on the CPU, wall s)."""
    t = {k: _to(v, device) for k, v in inputs.items() if k != "hp"}
    hp = inputs["hp"]
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained = minibatch_moddrop_impl(
        t["params"], t["X"], t["y"], t["w"], t["assign"], None, lr, hp["epochs"],
        hp["batch_size"], hp["dropout"], weight_decay, hp["moddrop_rate"], hp["per_sample"],
        perms=t["perms"], moddrop_keep=t["moddrop_keep"], dropout_keep=t["dropout_keep"])
    with torch.no_grad():
        probs = torch.sigmoid(mlp_apply(trained, t["X"]))
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return _to(trained, "cpu"), probs.cpu(), wall


def compare_card_with_cpu(inputs, atol, device="cuda"):
    """Run on the card and on the CPU; raise if either max abs error
    exceeds ``atol`` = (params, probs). -> (params err, probs err, card
    wall s, cpu wall s)."""
    card, p_card, t_card = run_trainer(inputs, device)
    cpu, p_cpu, t_cpu = run_trainer(inputs, "cpu")
    err_p = max(float((a[k] - b[k]).abs().max()) for a, b in zip(card, cpu) for k in ("w", "b"))
    err_y = float((p_card - p_cpu).abs().max())
    if err_p > atol[0] or err_y > atol[1]:
        raise AssertionError(
            f"fold-batched trainer, card vs CPU: params max abs err {err_p:.3e} (atol {atol[0]}),"
            f" probs {err_y:.3e} (atol {atol[1]})")
    return err_p, err_y, t_card, t_cpu


def check_mlp_apply(device="cuda", K=5, n=400, hidden=(64, 32), atol=1e-5, seed=0):
    """The fold-batched and the single-model forward on the card against
    the CPU (with dropout keeps). -> max abs error."""
    inputs = trainer_inputs(K=K, n=n, hidden=hidden, epochs=1, seed=seed)
    g = torch.Generator().manual_seed(seed)
    keeps = [torch.rand((K, n, h), generator=g) < 0.8 for h in hidden]
    err = 0.0
    for params, X, dk in ((inputs["params"], inputs["X"], keeps),
                          ([{k: v[0] for k, v in l.items()} for l in inputs["params"]],
                           inputs["X"][0], [k[0] for k in keeps])):
        want = mlp_apply(params, X, dropout_rate=0.2, dropout_keep=dk)
        got = mlp_apply(_to(params, device), X.to(device), dropout_rate=0.2,
                        dropout_keep=_to(dk, device)).cpu()
        err = max(err, float((got - want).abs().max()))
    if err > atol:
        raise AssertionError(f"mlp_apply card vs CPU: max abs err {err:.3e} (atol {atol})")
    return err


def quickstart_auc_draws(n_draws, first_seed=1000, quickstart="configs/quickstart.yaml"):
    """The quickstart model's full-observation test ROC-AUC on the seed-42
    frame and split, over ``n_draws`` init-and-training generator chains
    (seeds ``first_seed``, ``first_seed + 1``, ...), on the port's device.
    The quickstart trains 5 full-batch steps, so one chain's AUC is mostly
    set by its initial weights; the mean over chains is what a check can
    hold to the JAX package's."""
    from pd_fusion_torch.data.splits import get_subset_masks
    from pd_fusion_torch.evaluation.evaluate import evaluate_model
    from pd_fusion_torch.experiments import run_experiment as run
    from pd_fusion_torch.training.train import train_pipeline
    from pd_fusion_torch.utils import seed as seed_mod

    one = {"scenarios": [{"name": "full_observation", "drop_modalities": []}]}
    config, data_config, _ = run._load_configs(quickstart, {})
    aucs = []
    for s in range(first_seed, first_seed + n_draws):
        seed_mod.set_seed(42)  # the frame
        _, df, masks = run.load_dataset(config, data_config, True)
        tr, va, te = run.stratified_split(df, seed=42)
        seed_mod.set_seed(s)  # the generator chain
        model, prep = train_pipeline(dict(config), tr, va, get_subset_masks(masks, tr.index),
                                     get_subset_masks(masks, va.index))
        res = evaluate_model(model, te, get_subset_masks(masks, te.index), prep, one)
        aucs.append(res["full_observation"]["roc_auc"])
    return np.asarray(aucs)
