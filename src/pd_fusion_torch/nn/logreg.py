"""L2-penalised logistic regression with balanced class weights on the
port's device: the PPMI suites' ``LogisticRegression(class_weight=
"balanced")`` (``pd_fusion/analysis/tabular.py:469-472``,
``scripts/ppmi_train_tabular.py:202-206``). The card's machine has no
scikit-learn.

The objective is scikit-learn's with its default ``C=1``: ``sum_i s_i *
logloss(z_i, y_i) + ||w||^2 / 2`` with ``z = X w + b``, the intercept
unpenalised and the balanced sample weights ``s_i = n / (2 n_{y_i})``. It is strictly convex, so
it has one optimum; scikit-learn's lbfgs approaches it and stops at its
``tol`` (1e-4 by default), this solver goes to it.

Solver: Newton's method in float64 on the device, from zero weights. Each
step solves the (D+1)-square Hessian system and halves the step until the
objective does not increase (it rarely needs to). Stopping rule: the
largest absolute component of the gradient of the objective divided by
``sum_i s_i`` (the normalisation scikit-learn's ``tol`` applies to) is at
most ``TOL`` (1e-10), or ``max_iter`` steps were taken. One
host read of that norm per step is the only synchronisation.
"""
import numpy as np
import torch

from pd_fusion_torch.utils.device import get_device

TOL = 1e-10


def balanced_sample_weights(y: np.ndarray) -> np.ndarray:
    """``compute_class_weight("balanced")`` per sample: n / (2 * n_c)."""
    y = np.asarray(y).astype(np.int64)
    counts = np.bincount(y, minlength=2).astype(np.float64)
    return (len(y) / (2.0 * counts))[y]


def _objective(Xa, y, s, theta, reg):
    z = Xa @ theta
    loss = torch.sum(s * (torch.nn.functional.softplus(z) - y * z))
    return loss + 0.5 * torch.sum(reg * theta * theta)


class BalancedLogisticRegression:
    """scikit-learn-like binary classifier (labels 0/1): ``fit``,
    ``predict_proba``, ``predict``, ``coef_`` [1, D], ``intercept_`` [1],
    ``n_iter_`` [1]. Stores numpy state; runs on ``get_device()``."""

    def __init__(self, max_iter: int = 100):
        self.max_iter = int(max_iter)
        self.classes_ = np.array([0, 1])

    def fit(self, X, y):
        dev = get_device()
        X = np.asarray(X, np.float64)
        y = np.asarray(y).reshape(-1)
        if set(np.unique(y).tolist()) != {0, 1}:
            raise ValueError("BalancedLogisticRegression needs labels 0 and 1, both present")
        s = balanced_sample_weights(y)
        n, d = X.shape
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
        Xa = t(np.concatenate([X, np.ones((n, 1))], axis=1))
        yt, st = t(y.astype(np.float64)), t(s)
        reg = t(np.r_[np.ones(d), 0.0])
        theta = torch.zeros(d + 1, dtype=torch.float64, device=dev)
        scale = float(s.sum())
        f = _objective(Xa, yt, st, theta, reg)
        n_iter = 0
        for n_iter in range(1, self.max_iter + 1):
            p = torch.sigmoid(Xa @ theta)
            grad = Xa.T @ (st * (p - yt)) + reg * theta
            if float(grad.abs().max()) / scale <= TOL:
                n_iter -= 1
                break
            hess = (Xa.T * (st * p * (1.0 - p))) @ Xa + torch.diag(reg)
            step = torch.linalg.solve(hess, grad)
            t_len = 1.0
            while True:
                cand = theta - t_len * step
                f_new = _objective(Xa, yt, st, cand, reg)
                if bool(f_new <= f) or t_len < 1e-10:
                    break
                t_len *= 0.5
            theta, f = cand, f_new
        w = theta.cpu().numpy()
        self.coef_ = w[None, :d].copy()
        self.intercept_ = w[d:].copy()
        self.n_iter_ = np.array([n_iter])
        return self

    def decision_function(self, X) -> np.ndarray:
        dev = get_device()
        z = torch.as_tensor(np.asarray(X, np.float64), device=dev) @ torch.as_tensor(
            self.coef_[0], device=dev) + float(self.intercept_[0])
        return z.cpu().numpy()

    def predict_proba(self, X) -> np.ndarray:
        p1 = 1.0 / (1.0 + np.exp(-self.decision_function(X)))
        return np.stack([1.0 - p1, p1], axis=1)

    def predict(self, X) -> np.ndarray:
        return (self.decision_function(X) > 0).astype(np.int64)
