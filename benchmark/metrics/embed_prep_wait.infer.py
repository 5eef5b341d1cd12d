"""embed_prep_wait.infer: the program's span ``embed:prep_wait``, the embed
build's consume loop blocked on its prefetch threads' host preparation
(NIfTI read and inflate, resize, percentile normalisation, slice gather:
``imaging/pipeline.py::run_resnet_embedding_pipeline``), over the traced
window, in percent, in a cell that reports ``infer_slices_per_s``. Reads
nothing from a program without the span (a cell that builds nothing)."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "infer_slices_per_s", "embed:prep_wait")
