"""prep_wait.train: the program's span ``trainer:prep_wait``, the training
loop's wait for the next step's host preparation (slice loads, padded
batch, augmentation draws), made one step ahead on a worker thread, over
the traced window, in percent, in a cell that reports
``train_slices_per_s``. Reads nothing from a program without the span."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "train_slices_per_s", "trainer:prep_wait")
