"""prep_wait.infer: the program's span ``trainer:prep_wait``, the predict
loop's wait for the next TTA pass's host preparation (padded chunk,
augmentation draws), made one pass ahead on a worker thread, over the
traced window, in percent, in a cell that reports ``infer_slices_per_s``.
Reads nothing from a program without the span."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "infer_slices_per_s", "trainer:prep_wait")
