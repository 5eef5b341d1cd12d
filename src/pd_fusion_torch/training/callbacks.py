"""Training callbacks (own copy of ``pd_fusion/training/callbacks.py``).

``EarlyStopping`` is loss-patience early stopping; ``MetricEarlyStopping``
is the higher-is-better variant with lazy best-state capture that the MIL
fine-tune's host loop uses for its validation-AUC patience.
"""
from typing import Any, Callable, Optional


class EarlyStopping:
    """Loss-patience early stopping (lower is better)."""

    def __init__(self, patience: int = 5, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.best_loss: Optional[float] = None
        self.early_stop = False

    def __call__(self, val_loss: float) -> bool:
        if self.best_loss is None or val_loss < self.best_loss - self.min_delta:
            self.best_loss = val_loss
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop


class MetricEarlyStopping:
    """Higher-is-better early stopping with best-state capture.

    ``update(metric, capture_state)`` calls ``capture_state()`` lazily
    only on improvement; ``best_state`` holds the captured snapshot.
    """

    def __init__(self, patience: int = 5, min_delta: float = 0.0,
                 initial_best: float = float("-inf")):
        # initial_best matters in the degenerate all-exception case: the
        # MIL loops map a failed AUC to -1.0 and init best to -1.0
        # (reference mil_attention_finetune.py:169-252), so such epochs
        # never improve and best_state stays None -> no restore
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.best_metric = initial_best
        self.best_state: Any = None
        self.early_stop = False

    def update(self, metric: float, capture_state: Optional[Callable[[], Any]] = None) -> bool:
        if metric > self.best_metric + self.min_delta:
            self.best_metric = metric
            self.counter = 0
            if capture_state is not None:
                self.best_state = capture_state()
        else:
            self.counter += 1
            if self.patience > 0 and self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop
