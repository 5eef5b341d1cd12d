"""embed_staging.infer: the program's span ``embed:staging``, the embed
build's copies of each subject's slices into a pinned buffer and the issue
of each flush's host-to-device copy (``imaging/pipeline.py::_ToDevice``),
which waits where a pinned buffer's last copy has not ended, over the
traced window, in percent, in a cell that reports ``infer_slices_per_s``.
Reads nothing from a program without the span (a cell that builds
nothing)."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "infer_slices_per_s", "embed:staging")
