"""host_dispatch.train: the program's span ``step:ft_step``, the host's enqueue
of every training step: ``ft_step``'s body, with no wait for the device,
over the traced window, in percent, in a cell that reports
``train_slices_per_s``. Reads nothing from a program without the span."""
from benchmark.harness import program_spans


def read(ctx):
    return program_spans.span_share(ctx, "train_slices_per_s", "step:ft_step")
