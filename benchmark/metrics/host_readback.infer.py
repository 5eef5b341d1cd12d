"""host_readback.infer: the program's span ``trainer:readback``, the read-back
of every pass's probabilities (``.cpu().numpy()``), which waits for the pass
on the device, over the traced window, in percent, in a cell that reports
``infer_slices_per_s``. Reads nothing from a program without the span."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "infer_slices_per_s", "trainer:readback")
