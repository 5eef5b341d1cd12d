"""Dataset splitting (port of ``pd_fusion/data/splits.py``).

Fold-assignment parity with the JAX package is a hard requirement for
metric parity under CV. The JAX package calls scikit-learn's
``StratifiedGroupKFold`` / ``StratifiedKFold`` / ``train_test_split``
(stratified or not, float or integer sizes) with ``shuffle=True,
random_state=seed``. The port runs where scikit-learn is not installed,
so it keeps numpy copies of those algorithms that consume a ``np.random.RandomState(seed)`` in
scikit-learn's order and give bit-identical folds (held against
scikit-learn in the tests).
"""
from collections import defaultdict
from math import ceil, floor
from typing import Dict, Generator, List, Tuple

import numpy as np
import pandas as pd

from pd_fusion_torch.data.schema import TARGET_COL

FrameSplits = Generator[Tuple[pd.DataFrame, pd.DataFrame], None, None]


# ---------------------------------------------------------------------------
# scikit-learn's splitters, as numpy (shuffle=True, integer random_state)
# ---------------------------------------------------------------------------


def _stratified_kfold_test_folds(y, n_splits: int, rng) -> np.ndarray:
    """Fold id of every sample (``StratifiedKFold._make_test_folds``)."""
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    # classes encoded by order of first appearance
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    if np.all(n_splits > y_counts):
        raise ValueError(
            f"n_splits={n_splits} cannot be greater than the number of members in each class."
        )
    # round robin over the sorted labels: samples of each class per fold
    y_order = np.sort(y_encoded)
    allocation = np.asarray(
        [np.bincount(y_order[i::n_splits], minlength=n_classes) for i in range(n_splits)]
    )
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    return test_folds


def _find_best_fold(y_counts_per_fold, y_cnt, group_y_counts, n_splits: int) -> int:
    best_fold = None
    min_eval = np.inf
    min_samples_in_fold = np.inf
    for i in range(n_splits):
        y_counts_per_fold[i] += group_y_counts
        # the spread of each class's share over the proposed folds
        std_per_class = np.std(y_counts_per_fold / y_cnt.reshape(1, -1), axis=0)
        y_counts_per_fold[i] -= group_y_counts
        fold_eval = np.mean(std_per_class)
        samples_in_fold = np.sum(y_counts_per_fold[i])
        is_better = fold_eval < min_eval or (
            np.isclose(fold_eval, min_eval) and samples_in_fold < min_samples_in_fold
        )
        if is_better:
            min_eval = fold_eval
            min_samples_in_fold = samples_in_fold
            best_fold = i
    return best_fold


def _stratified_group_kfold_test_indices(y, groups, n_splits: int, rng) -> List[List[int]]:
    """Test indices of every fold (``StratifiedGroupKFold._iter_test_indices``):
    groups, shuffled, then taken in order of decreasing class-count spread,
    each go to the fold that keeps the class shares most even."""
    _, y_inv, y_cnt = np.unique(y, return_inverse=True, return_counts=True)
    if np.all(n_splits > y_cnt):
        raise ValueError(
            f"n_splits={n_splits} cannot be greater than the number of members in each class."
        )
    n_classes = len(y_cnt)
    _, groups_inv, groups_cnt = np.unique(groups, return_inverse=True, return_counts=True)
    n_groups = len(groups_cnt)
    if n_splits > n_groups:
        raise ValueError(
            f"Cannot have number of splits n_splits={n_splits} greater than the number "
            f"of groups: {n_groups}."
        )
    y_counts_per_group = np.zeros((n_groups, n_classes))
    for class_idx, group_idx in zip(y_inv, groups_inv):
        y_counts_per_group[group_idx, class_idx] += 1
    y_counts_per_fold = np.zeros((n_splits, n_classes))
    groups_per_fold = defaultdict(set)

    perm = np.arange(n_groups)
    rng.shuffle(perm)
    y_counts_per_group = y_counts_per_group[perm]
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(perm.size)
    groups_inv = inv_perm[groups_inv]

    # stable sort keeps the shuffled order among equal spreads
    sorted_groups_idx = np.argsort(-np.std(y_counts_per_group, axis=1), kind="stable")
    for group_idx in sorted_groups_idx:
        group_y_counts = y_counts_per_group[group_idx]
        best_fold = _find_best_fold(y_counts_per_fold, y_cnt, group_y_counts, n_splits)
        y_counts_per_fold[best_fold] += group_y_counts
        groups_per_fold[best_fold].add(group_idx)
    return [
        [idx for idx, g in enumerate(groups_inv) if g in groups_per_fold[i]]
        for i in range(n_splits)
    ]


def _approximate_mode(class_counts, n_draws: int, rng) -> np.ndarray:
    """Approximate mode of the multivariate hypergeometric; ties in the
    leftover share are broken by ``rng`` (scikit-learn's helper)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        values = np.sort(np.unique(remainder))[::-1]
        for value in values:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _validate_shuffle_split(n_samples: int, test_size, train_size, default_test_size=None):
    """(n_train, n_test) as scikit-learn's ``_validate_shuffle_split``: a
    float test size rounds up, a float train size rounds down, an int is a
    count, and a missing size takes the rest."""
    if test_size is None and train_size is None:
        test_size = default_test_size
    test_kind = np.asarray(test_size).dtype.kind
    train_kind = np.asarray(train_size).dtype.kind
    for name, size, kind in (("test_size", test_size, test_kind),
                             ("train_size", train_size, train_kind)):
        if (kind == "i" and (size >= n_samples or size <= 0)) or (
                kind == "f" and (size <= 0 or size >= 1)):
            raise ValueError(f"{name}={size} should be either positive and smaller than the "
                             f"number of samples {n_samples} or a float in the (0, 1) range")
        if size is not None and kind not in ("i", "f"):
            raise ValueError(f"Invalid value for {name}: {size}")
    if train_kind == "f" and test_kind == "f" and train_size + test_size > 1:
        raise ValueError(f"The sum of test_size and train_size = {train_size + test_size}, "
                         "should be in the (0, 1) range. Reduce test_size and/or train_size.")
    n_test = ceil(test_size * n_samples) if test_kind == "f" else (
        float(test_size) if test_kind == "i" else None)
    n_train = floor(train_size * n_samples) if train_kind == "f" else (
        float(train_size) if train_kind == "i" else None)
    if train_size is None:
        n_train = n_samples - n_test
    elif test_size is None:
        n_test = n_samples - n_train
    if n_train + n_test > n_samples:
        raise ValueError(f"The sum of train_size and test_size = {int(n_train + n_test)}, "
                         f"should be smaller than the number of samples {n_samples}. "
                         "Reduce test_size and/or train_size.")
    n_train, n_test = int(n_train), int(n_test)
    if n_train == 0:
        raise ValueError(f"With n_samples={n_samples}, test_size={test_size} and "
                         f"train_size={train_size}, the resulting train set will be empty. "
                         "Adjust any of the aforementioned parameters.")
    return n_train, n_test


def _stratified_shuffle_split(y, n_train: int, n_test: int, rng):
    """(train, test) positions of one ``StratifiedShuffleSplit`` split."""
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    n_classes = classes.shape[0]
    if np.min(class_counts) < 2:
        raise ValueError("The least populated class in y has only 1 member, which is too few.")
    if n_train < n_classes or n_test < n_classes:
        raise ValueError(
            f"train ({n_train}) and test ({n_test}) sizes must each be at least the "
            f"number of classes ({n_classes})"
        )
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(n_classes):
        permutation = rng.permutation(class_counts[i])
        perm_indices_class_i = class_indices[i].take(permutation, mode="clip")
        train.extend(perm_indices_class_i[: n_i[i]])
        test.extend(perm_indices_class_i[n_i[i]: n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def train_test_split_positions(n_samples: int, train_size=None, test_size=None, stratify=None,
                               seed: int = None):
    """(train, test) positions of ``train_test_split(range(n_samples),
    train_size=.., test_size=.., stratify=.., random_state=seed)``: one
    ``StratifiedShuffleSplit`` split when ``stratify`` is given, else one
    ``ShuffleSplit`` split (a permutation whose head is the test part)."""
    n_train, n_test = _validate_shuffle_split(n_samples, test_size, train_size, 0.25)
    # the splitter re-validates the integer sizes it is handed
    _validate_shuffle_split(n_samples, n_test, n_train)
    rng = np.random.RandomState(seed)
    if stratify is not None:
        return _stratified_shuffle_split(np.asarray(stratify), n_train, n_test, rng)
    permutation = rng.permutation(n_samples)
    return permutation[n_test: n_test + n_train], permutation[:n_test]


def _masks_to_splits(n: int, test_sets) -> Generator[Tuple[np.ndarray, np.ndarray], None, None]:
    indices = np.arange(n)
    for test in test_sets:
        mask = np.zeros(n, dtype=bool)
        mask[test] = True
        yield indices[~mask], indices[mask]


def _stratified_group_kfold(y, groups, n_splits: int, seed: int):
    rng = np.random.RandomState(seed)
    tests = _stratified_group_kfold_test_indices(np.asarray(y), np.asarray(groups), n_splits, rng)
    return _masks_to_splits(len(y), tests)


def _stratified_kfold(y, n_splits: int, seed: int):
    if n_splits > len(y):
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} greater than "
                         f"the number of samples: n_samples={len(y)}.")
    folds = _stratified_kfold_test_folds(np.asarray(y), n_splits, np.random.RandomState(seed))
    return _masks_to_splits(len(y), (folds == i for i in range(n_splits)))


# ---------------------------------------------------------------------------
# frame-level API (same as the JAX package's)
# ---------------------------------------------------------------------------


def _iter_row_splits(df: pd.DataFrame, splits) -> FrameSplits:
    """Yield (train_df, val_df) row slices for every (train, test) split."""
    for train_idx, val_idx in splits:
        yield df.iloc[train_idx], df.iloc[val_idx]


def stratified_split(
    df: pd.DataFrame, test_size: float = 0.2, val_size: float = 0.1, seed: int = 42
):
    """70/10/20 stratified train/val/test split (two chained holdouts)."""
    y = df[TARGET_COL].to_numpy()
    tr, te = train_test_split_positions(len(y), test_size=test_size, stratify=y, seed=seed)
    train_val, test = df.iloc[tr], df.iloc[te]
    y = train_val[TARGET_COL].to_numpy()
    tr, va = train_test_split_positions(
        len(y), test_size=val_size / (1 - test_size), stratify=y, seed=seed
    )
    return train_val.iloc[tr], train_val.iloc[va], test


def get_kfold_splits(df: pd.DataFrame, n_splits: int = 5, seed: int = 42) -> FrameSplits:
    return _iter_row_splits(df, _stratified_kfold(df[TARGET_COL].to_numpy(), n_splits, seed))


def get_group_kfold_splits(
    df: pd.DataFrame,
    n_splits: int = 5,
    seed: int = 42,
    group_col: str = "subject_id",
) -> FrameSplits:
    return _iter_row_splits(
        df, _stratified_group_kfold(df[TARGET_COL].to_numpy(), df[group_col].to_numpy(),
                                    n_splits, seed)
    )


def split_train_calibration(
    df: pd.DataFrame,
    calib_size: float = 0.2,
    seed: int = 42,
    group_col: str = None,
) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """Nested train/calibration split, group-aware when ``group_col`` given."""
    if not 0 < calib_size < 1:
        raise ValueError("calib_size must be between 0 and 1.")
    if group_col and group_col in df.columns:
        # first fold of a group K-fold whose fold count approximates calib_size
        n_splits = max(2, int(round(1.0 / calib_size)))
        return next(get_group_kfold_splits(df, n_splits, seed, group_col))
    y = df[TARGET_COL].to_numpy()
    tr, te = train_test_split_positions(len(y), test_size=calib_size, stratify=y, seed=seed)
    return df.iloc[tr], df.iloc[te]


def get_subset_masks(maskdict: Dict, indices: pd.Index) -> Dict:
    """Positional mask slicing: mask arrays are aligned with the original
    dataframe's RangeIndex, so df.index values double as positions."""
    return {k: v[indices] for k, v in maskdict.items()}
