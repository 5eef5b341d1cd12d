"""host_draws.train: the program's span ``trainer:_aug_params``, the numpy
augmentation draws of every step (angle, translation, intensity and the
noise over ``[B, L, h, w]``), over the traced window, in percent, in a cell
that reports ``train_slices_per_s``. Reads nothing from a program without
the span."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "train_slices_per_s", "trainer:_aug_params")
