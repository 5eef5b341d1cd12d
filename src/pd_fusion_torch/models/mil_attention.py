"""MIL attention model over precomputed per-slice embedding bags (port of
``pd_fusion/models/mil_attention.py``).

Params hidden_dim / attn_dim / dropout / gated / missing_prob / lr /
weight_decay / batch_size / epochs / max_grad_norm /
early_stopping_patience / class_weight ("balanced" -> pos_weight =
neg/pos) / pos_weight; missing bags (None, or masks["mri"] == 0) predict
the constant ``missing_prob``. Bags pad to one max length (rounded up to
a multiple of 8, as in the JAX package) shared by train/val/predict; the
masked softmax makes the padding exact. Weights live on the port's device
(``utils/device.py``).
"""
import numpy as np
import torch

from pd_fusion_torch.models.base import BaseModel
from pd_fusion_torch.nn.mil import (
    mil_init, mil_predict, pad_bags, params_from_jax, params_to_numpy, train_mil,
)
from pd_fusion_torch.utils.device import get_device
from pd_fusion_torch.utils.io import load_pickle, save_pickle
from pd_fusion_torch.utils.seed import fresh_generator


def _round_up(x, m=8):
    return ((x + m - 1) // m) * m


class MilAttentionModel(BaseModel):
    def __init__(self, input_dim: int, params: dict, device=None):
        self.params = params or {}
        self.device = get_device(device)
        self.input_dim = int(input_dim)
        self.hidden_dim = int(self.params.get("hidden_dim", 128))
        self.attn_dim = int(self.params.get("attn_dim", 64))
        self.dropout = float(self.params.get("dropout", 0.3))
        self.gated = bool(self.params.get("gated", False))
        self.missing_prob = float(self.params.get("missing_prob", 0.5))
        self.max_len = int(self.params["max_len"]) if "max_len" in self.params else None
        self.net_params = mil_init(
            fresh_generator(), self.input_dim, self.hidden_dim, self.attn_dim, self.gated,
            device=self.device,
        )

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _resolve_pos_weight(self, y):
        if self.params.get("class_weight") == "balanced":
            pos = float((np.asarray(y) == 1).sum())
            neg = float((np.asarray(y) == 0).sum())
            return neg / pos if pos > 0 else 1.0
        if self.params.get("pos_weight") is not None:
            return float(self.params["pos_weight"])
        return 1.0

    def train(self, bags, y, val_data=None):
        # drop missing bags together with their labels
        kept = [i for i, b in enumerate(bags) if b is not None]
        real = [np.asarray(bags[i], np.float32) for i in kept]
        y = np.asarray(y, np.float32)[kept]
        lens = [b.shape[0] for b in real]
        if self.max_len is None:
            self.max_len = _round_up(max(lens))
            if val_data is not None:
                v_lens = [np.asarray(b).shape[0] for b in val_data[0] if b is not None]
                if v_lens:
                    self.max_len = max(self.max_len, _round_up(max(v_lens)))
        elif self.max_len < max(lens):
            raise ValueError(
                f"config max_len={self.max_len} would truncate training bags "
                f"(longest bag has {max(lens)} instances)"
            )

        X, bag_mask = pad_bags(real, self.max_len)
        y_arr = np.asarray(y, np.float32)

        patience = int(self.params.get("early_stopping_patience", 0))
        track_best = bool(val_data is not None and patience > 0)
        vmiss = None
        if track_best:
            # the whole val set scores each epoch: a None bag contributes
            # the constant missing_prob with its true label. Val bags
            # longer than max_len widen the val pad locally.
            val_bags, y_val = val_data
            nv = len(val_bags)
            v_real = [i for i, b in enumerate(val_bags) if b is not None]
            vlen = self.max_len
            if v_real:
                vlen = max(vlen, _round_up(max(np.asarray(val_bags[i]).shape[0] for i in v_real)))
            Xv = np.zeros((nv, vlen, self.input_dim), np.float32)
            # all-ones mask on missing rows: finite logits through the
            # masked softmax (overridden by vmiss before the AUC)
            mv = np.ones((nv, vlen), np.float32)
            if v_real:
                xr, mr = pad_bags([np.asarray(val_bags[i], np.float32) for i in v_real], vlen)
                Xv[v_real], mv[v_real] = xr, mr
            yv = np.asarray(y_val, np.float32)
            wv = np.ones(nv, np.float32)
            vmiss = self._t([0.0 if b is not None else 1.0 for b in val_bags])
        else:
            Xv = np.zeros((1, self.max_len, self.input_dim), np.float32)
            mv = np.ones((1, self.max_len), np.float32)
            yv = np.zeros(1, np.float32)
            wv = np.zeros(1, np.float32)

        max_grad_norm = self.params.get("max_grad_norm")
        self.net_params = train_mil(
            self.net_params, self._t(X), self._t(bag_mask), self._t(y_arr),
            self._t(Xv), self._t(mv), self._t(yv), self._t(wv),
            fresh_generator(self.device),
            float(self.params.get("lr", 1e-3)),
            float(np.float32(self._resolve_pos_weight(y_arr))),
            float(np.float32(max_grad_norm if max_grad_norm else 1.0)),
            int(self.params.get("epochs", 30)),
            min(int(self.params.get("batch_size", 16)), len(real)),
            self.gated,
            self.dropout,
            float(self.params.get("weight_decay", 0.0)),
            bool(max_grad_norm),
            track_best,
            patience=patience if track_best else 0,
            vmiss=vmiss,
            missing_prob=self.missing_prob,
        )

    def predict_proba(self, bags, masks=None):
        mri_mask = masks.get("mri") if isinstance(masks, dict) else None
        n = len(bags)
        missing = np.array(
            [bags[i] is None or (mri_mask is not None and mri_mask[i] == 0) for i in range(n)]
        )
        out = np.full(n, self.missing_prob, np.float32)
        present = np.where(~missing)[0]
        if len(present):
            # never truncate: a held-out bag longer than anything seen at
            # train time widens the pad
            max_len = max(
                self.max_len or 0,
                _round_up(max(np.asarray(bags[i]).shape[0] for i in present)),
            )
            X, bag_mask = pad_bags([np.asarray(bags[i], np.float32) for i in present], max_len)
            probs = mil_predict(self.net_params, self._t(X), self._t(bag_mask), self.gated)
            out[present] = probs.cpu().numpy()
        return out

    def save(self, path):
        save_pickle(
            {
                "kind": "mil_attention",
                "input_dim": self.input_dim,
                "params": self.params,
                "max_len": self.max_len,
                "net_params": params_to_numpy(self.net_params),
            },
            path,
        )

    @classmethod
    def load(cls, path, input_dim=None, params=None, device=None):
        state = load_pickle(path)
        inst = cls(state["input_dim"], state["params"], device=device)
        inst.max_len = state["max_len"]
        inst.net_params = params_from_jax(state["net_params"], device=inst.device)
        return inst
