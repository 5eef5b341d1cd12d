"""mfu.infer: the forward's model FLOPs of every TTA pass in the traced
window (``flops.predict_pass``) over the window's length times the card's
float32 peak, in percent. Reads nothing in a cell that does not report
``infer_slices_per_s``."""


def read(ctx):
    if ctx["drive"].rate != "infer_slices_per_s" or not ctx["peak"]:
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"] * ctx["peak"]["float32_flops"])
