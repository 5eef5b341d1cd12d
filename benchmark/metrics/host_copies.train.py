"""host_copies.train: the program's span ``trainer:_t``, every host-to-device
copy of ``train`` (the batch, its masks, the draws, the dropout keeps, the
normalisation constants), each waiting as long as the copy keeps the host,
over the traced window, in percent, in a cell that reports
``train_slices_per_s``. Reads nothing from a program without the span."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "train_slices_per_s", "trainer:_t")
