"""host_copies.infer: the program's span ``trainer:_t``, every host-to-device
copy of ``predict_proba`` (each chunk, its mask, each pass's draws and
normalisation constants), over the traced window, in percent, in a cell that
reports ``infer_slices_per_s``. Reads nothing from a program without the
span."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "infer_slices_per_s", "trainer:_t")
