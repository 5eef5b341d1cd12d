"""grid_attn_dispatch.train: the program's span ``backbone:grid_attention``,
the host's enqueue of every block's grid partition, attention and reverse
in a MaxViT backbone's training forwards, over the traced window, in
percent, in a cell that reports ``train_slices_per_s``. Reads nothing from
a program without the span."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "train_slices_per_s", "backbone:grid_attention")
