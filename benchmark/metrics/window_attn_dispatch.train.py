"""window_attn_dispatch.train: the program's span ``backbone:window_attention``,
the host's enqueue of every block's shift, window partition, attention and
reverse in the training steps' forward passes, over the traced window, in
percent, in a cell that reports ``train_slices_per_s``. Reads nothing from
a program without the span."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "train_slices_per_s", "backbone:window_attention")
