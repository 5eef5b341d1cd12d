"""device_idle.train: the share of the traced window in which nothing ran
on the card (no kernel, copy or set, from the profiler's CUDA activity),
in percent, in a cell that reports ``train_slices_per_s``."""


def read(ctx):
    if ctx["drive"].rate != "train_slices_per_s" or ctx["device"].type != "cuda":
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
