"""mbconv_dispatch.train: the program's span ``backbone:mbconv``, the host's
enqueue of every MBConv of a MaxViT backbone in the training steps, its
recompute in the backward included, over the traced window, in percent, in
a cell that reports ``train_slices_per_s``. Reads nothing from a program
without the span (a ResNet or Swin backbone, or no MaxViT)."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "train_slices_per_s", "backbone:mbconv")
