"""recomputed.train: the MBConv forwards the program runs again in a
training step's backward (counter ``backbone:recomputed``) over
``trainer:steps``, in a cell that reports ``train_slices_per_s``: 11 a
MaxViT-T step, one per MBConv. Reads nothing from a program without the
counter (one that keeps every activation)."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.counter_ratio(ctx, "train_slices_per_s", "backbone:recomputed",
                                       "trainer:steps")
