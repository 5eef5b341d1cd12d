"""mfu.train: the model FLOPs of the training steps in the traced window
(``flops.train_step``: 3F - F_stem an image and the head's linears, no
recompute) over the window's length times the card's float32 peak, in
percent. Reads nothing in a cell that does not report
``train_slices_per_s``."""


def read(ctx):
    if ctx["drive"].rate != "train_slices_per_s" or not ctx["peak"]:
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"] * ctx["peak"]["float32_flops"])
