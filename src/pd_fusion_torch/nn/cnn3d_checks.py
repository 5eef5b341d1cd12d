"""One CNN3D training step on the card against the same step on the CPU, for
``chip_smoke.py`` and the ``cuda``-marked tests.

From one init (``cnn3d_init``, a CPU generator) and the same batch (the
first batch of one permutation, as ``train_cnn3d`` forms it), one
``train_step`` on each device; then the embeddings of the batch with the
new weights. Float32 on both, TF32 off on the card. Tolerances:

- the loss before the step to rtol ``LOSS_RTOL``;
- Adam's moments within ``MOMENT_REL`` of their L2 norm, leaf by leaf: the
  first layer's weight gradient sums some 2 million products per weight
  at 64^3 and cancels, so float32 sums taken in other orders disagree
  there far more than on the other leaves;
- the weights: Adam's first step is about +-lr a weight whatever the
  gradient's size, so where a gradient is within the devices' float32
  disagreement the two may differ by up to 2 lr. So each device's new
  weights must equal its start minus ``lr * mu_hat / (sqrt(nu_hat) +
  eps)`` of its own moments within ``WEIGHT_ATOL`` (float64 on the host),
  and the moments agree as above; the largest difference between the
  devices' weights is reported;
- the embeddings within ``EMB_REL`` of their largest magnitude.
"""
from typing import Dict

import numpy as np
import torch

from pd_fusion_torch.nn import cnn3d, ft_optim

# configs/data_openneuro_ds001907.yaml's cnn_config, and the runbook's command
# (RUNBOOK_OPENNEURO_DS001907.md: 96^3, embedding 128, batch 4)
CNN_CONFIG = {"target_shape": (64, 64, 64), "embedding_dim": 64, "batch_size": 8, "lr": 1e-3}
RUNBOOK_CONFIG = {"target_shape": (96, 96, 96), "embedding_dim": 128, "batch_size": 4,
                  "lr": 1e-3}
LOSS_RTOL = 1e-5
MOMENT_REL = 1e-2
WEIGHT_ATOL = 1e-6
EMB_REL = 1e-3


def synthetic_volumes(n: int, shape, seed: int = 0) -> np.ndarray:
    """[n, D, H, W] z-scored noise with a brighter box, float32."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, *shape), dtype=np.float32)
    d, h, w = shape
    v[:, d // 4: 3 * d // 4, h // 4: 3 * h // 4, w // 4: 3 * w // 4] += 2.0
    mu = v.mean(axis=(1, 2, 3), keepdims=True)
    sd = v.std(axis=(1, 2, 3), keepdims=True)
    return ((v - mu) / (sd + 1e-6)).astype(np.float32)


def first_batch(n: int, batch_size: int, seed: int = 1):
    """The first batch of one permutation of n: (indices, weights) [batch_size]."""
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(n))
    idx, w = cnn3d.epoch_batches(perm, batch_size)
    return idx[0], w[0]


def _own_adam_error(start, new, opt, lr) -> float:
    """Largest |new - (start - lr * mu_hat / (sqrt(nu_hat) + eps))| over the
    leaves, from the device's own moments, in float64 on the host."""
    c = opt["count"]
    err = 0.0
    for w0, w1, mu, nu in zip(start, new, opt["mu"], opt["nu"]):
        mu_hat = mu.double().cpu() / (1.0 - ft_optim.BETA1**c)
        nu_hat = nu.double().cpu() / (1.0 - ft_optim.BETA2**c)
        want = w0.double().cpu() - lr * mu_hat / (torch.sqrt(nu_hat) + ft_optim.EPS)
        err = max(err, float((w1.double().cpu() - want).abs().max()))
    return err


def _require(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def compare_card_with_cpu(volumes: np.ndarray, device, config: Dict = CNN_CONFIG,
                          seed: int = 0) -> Dict[str, float]:
    """One step on ``volumes`` [N, D, H, W] (N >= the batch size) at
    ``config``'s widths on ``device`` and on the CPU. -> the largest error
    of each quantity (raises ``AssertionError`` on a miss)."""
    shape = tuple(config["target_shape"])
    lr = float(config["lr"])
    start = cnn3d.cnn3d_init(torch.Generator().manual_seed(seed), shape,
                             int(config["embedding_dim"]))
    idx, w = first_batch(len(volumes), int(config["batch_size"]), seed + 1)
    xb = torch.from_numpy(volumes)[idx][:, None]
    out = []
    for dev in ("cpu", device):
        params = cnn3d.params_to(start, dev)
        opt = cnn3d.init_opt(params)
        x = xb.to(dev)
        new, loss = cnn3d.train_step(params, opt, x, w.to(dev), lr, shape)
        out.append((new, float(loss), opt, cnn3d.cnn3d_embed(new, x, shape).cpu()))
    (cpu_w, cpu_loss, cpu_opt, cpu_emb), (card_w, card_loss, card_opt, card_emb) = out
    errs = {"loss_rel": abs(card_loss - cpu_loss) / abs(cpu_loss)}
    _require(errs["loss_rel"] <= LOSS_RTOL, f"loss {card_loss} vs {cpu_loss}")
    moment = 0.0
    for key in ("mu", "nu"):
        for a, b in zip(card_opt[key], cpu_opt[key]):
            b = b.double()
            moment = max(moment, float((a.double().cpu() - b).norm() / b.norm().clamp_min(1e-30)))
    errs["moment_rel_l2"] = moment
    _require(moment <= MOMENT_REL, f"Adam moments {moment} of their norm apart")
    leaves0 = cnn3d.leaves(start)
    errs["own_adam"] = max(_own_adam_error(leaves0, cnn3d.leaves(cpu_w), cpu_opt, lr),
                           _own_adam_error(leaves0, cnn3d.leaves(card_w), card_opt, lr))
    _require(errs["own_adam"] <= WEIGHT_ATOL,
             f"a device's weights are not its own Adam step: {errs}")
    errs["weights_max_abs"] = max(float((a.cpu() - b).abs().max())
                                  for a, b in zip(cnn3d.leaves(card_w), cnn3d.leaves(cpu_w)))
    scale = float(cpu_emb.abs().max())
    errs["emb_rel"] = float((card_emb - cpu_emb).abs().max()) / scale
    _require(errs["emb_rel"] <= EMB_REL, f"embeddings {errs['emb_rel']} of their scale apart")
    return errs


def forward_flops(input_shape, embedding_dim: int) -> Dict[str, int]:
    """Multiply-add FLOPs (2 per MAC) of one volume's forward, by layer."""
    d, h, w = input_shape
    out = {}
    vox = d * h * w
    for name, cin, cout in cnn3d.ENCODER:
        out[name] = 2 * vox * cout * cin * 27
        vox //= 8
    enc_dim = int(np.prod(cnn3d.ae_enc_shape(input_shape)))
    out["fc"] = 2 * enc_dim * embedding_dim
    out["fc_dec"] = 2 * embedding_dim * enc_dim
    vox = int(np.prod(cnn3d.ae_enc_shape(input_shape)[:3]))
    for name, cin, cout in cnn3d.DECODER:
        vox *= 8
        out[name] = 2 * vox * cout * cin
    return out


def train_step_flops(input_shape, embedding_dim: int, batch: int) -> int:
    """One step's FLOPs: the forward, the weight gradients (as many) and the
    data gradients (as many, less the first layer's, which no one needs)."""
    f = forward_flops(input_shape, embedding_dim)
    return batch * (3 * sum(f.values()) - f["enc1"])
