"""The port's balanced logistic regression (``pd_fusion_torch/nn/logreg.py``)
against scikit-learn's ``LogisticRegression(class_weight="balanced")``,
which the JAX package's suites call (CPU).

Tolerances: the coefficients and intercept within 1e-5 of the largest
coefficient of scikit-learn's fit run to its optimum (``tol=1e-10``,
``max_iter=10000``; both minimise the same strictly convex objective);
the probabilities within 1e-3 of the default-tolerance fits the JAX suites
make (``max_iter`` 1000 and 2000, lbfgs stops at ``tol=1e-4``), on
standardised designs of the suites' test-frame sizes. The card against the
CPU is ``tests/test_torch_port_cuda.py``'s case (that file runs on the
card's machine, which has no JAX).
"""
import warnings

import numpy as np
import pytest

from pd_fusion_torch.analysis.tabular import balanced_logreg
from pd_fusion_torch.nn.logreg import BalancedLogisticRegression, balanced_sample_weights
from test_torch_port_jax_draws import one_cpu_thread


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    with one_cpu_thread():
        yield


def _design(n, d, seed, prevalence_shift=0.8):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    X[:, 1:] += 0.5 * X[:, :1]
    y = (X[:, 0] + rng.randn(n) > prevalence_shift).astype(int)
    return (X - X.mean(0)) / X.std(0), y


def _sklearn(X, y, **kw):
    from sklearn.linear_model import LogisticRegression

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return LogisticRegression(class_weight="balanced", **kw).fit(X, y)


@pytest.mark.parametrize("n,d,seed", [(60, 3, 0), (120, 12, 1), (200, 40, 2), (400, 25, 3)])
def test_coefficients_equal_scikit_learn_at_its_optimum(n, d, seed):
    X, y = _design(n, d, seed)
    got = BalancedLogisticRegression(max_iter=1000).fit(X, y)
    want = _sklearn(X, y, tol=1e-10, max_iter=10000)
    scale = np.abs(want.coef_).max()
    np.testing.assert_allclose(got.coef_, want.coef_, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got.intercept_, want.intercept_, rtol=0, atol=1e-5 * scale)
    assert got.coef_.shape == (1, d) and got.n_iter_[0] < 50


@pytest.mark.parametrize("n,d,seed,max_iter", [(60, 3, 0, 1000), (120, 9, 1, 2000),
                                               (96, 11, 4, 2000)])
def test_probabilities_within_1e3_of_the_suites_default_fit(n, d, seed, max_iter):
    X, y = _design(n, d, seed)
    got = balanced_logreg(max_iter).fit(X, y)
    want = _sklearn(X, y, max_iter=max_iter)
    np.testing.assert_allclose(got.predict_proba(X), want.predict_proba(X), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.predict(X), want.predict(X))


def test_balanced_weights_are_scikit_learns():
    from sklearn.utils.class_weight import compute_sample_weight

    for y in (np.array([0, 1, 1, 1, 0, 1, 1]), np.r_[np.zeros(40, int), np.ones(7, int)]):
        np.testing.assert_allclose(balanced_sample_weights(y),
                                   compute_sample_weight("balanced", y))


def test_one_class_is_refused():
    X, _ = _design(150, 6, 6)
    with pytest.raises(ValueError, match="both present"):
        BalancedLogisticRegression().fit(X, np.ones(150, int))


def test_separable_data_stays_finite():
    """The L2 term keeps the optimum finite where the classes separate; the
    step halving keeps Newton from overshooting."""
    X = np.r_[np.linspace(-3, -0.5, 30), np.linspace(0.5, 3, 10)][:, None]
    y = np.r_[np.zeros(30, int), np.ones(10, int)]
    got = BalancedLogisticRegression(max_iter=100).fit(X, y)
    want = _sklearn(X, y, tol=1e-10, max_iter=10000)
    assert np.isfinite(got.coef_).all()
    np.testing.assert_allclose(got.coef_, want.coef_, rtol=1e-5)
