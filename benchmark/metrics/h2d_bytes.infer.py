"""h2d_bytes.infer: the bytes the program copies from the host to the device
(counter ``trainer:h2d_bytes``) in a predict pass (each chunk's own copies
shared over its TTA passes), counted by ``trainer:passes``, in MB (1e6
bytes), in a cell that reports ``infer_slices_per_s``. Reads nothing from a
program without the counters."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.counter_ratio(ctx, "infer_slices_per_s", "trainer:h2d_bytes", "trainer:passes",
                                       1e-6)
