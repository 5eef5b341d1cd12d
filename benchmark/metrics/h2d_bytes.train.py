"""h2d_bytes.train: the bytes the program copies from the host to the device
(counter ``trainer:h2d_bytes``) in a training step, counted by
``trainer:steps``, in MB (1e6 bytes), in a cell that reports
``train_slices_per_s``. Reads nothing from a program without the counters."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.counter_ratio(ctx, "train_slices_per_s", "trainer:h2d_bytes", "trainer:steps",
                                       1e-6)
