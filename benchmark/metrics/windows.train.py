"""windows.train: the window attentions the program's backbone runs in a
training step (counter ``backbone:windows``, images times windows summed
over the blocks) over ``trainer:steps``, in thousands, in a cell that
reports ``train_slices_per_s``. Reads nothing from a program without the
counters (a ResNet backbone counts no windows)."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.counter_ratio(ctx, "train_slices_per_s", "backbone:windows",
                                       "trainer:steps", 1e-3)
