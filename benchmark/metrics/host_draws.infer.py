"""host_draws.infer: the program's span ``trainer:_aug_params``, the numpy
augmentation draws of every TTA pass, over the traced window, in percent, in
a cell that reports ``infer_slices_per_s``. Reads nothing from a program
without the span."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "infer_slices_per_s", "trainer:_aug_params")
