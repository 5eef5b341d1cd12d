"""dwconv_roofline.train: the program's depthwise convolution of every
MBConv (``nn/maxvit.py::depthwise_conv``, whatever implements it), forward
and both gradients at the training step's shapes, against its roofline
bound, in percent: the sum over the MBConvs of max(FLOPs / the card's
float32 peak, unavoidable bytes / its memory bandwidth), over the device
time between CUDA events. FLOPs are three times the forward's ``2 * 9 *
mid`` a position; bytes are x, w, y and the gradient of each, read or
written once (``flops_maxvit.depthwise``): no implementation can pass
100%.

Times the program's function after the window on random x [B * L, mid,
side, side] (channels-last, the step's layout) of each MBConv's shape
with the block's own stride and a random weight, then
``torch.autograd.grad`` of the output against a fixed random gradient
over x and w. One warm-up, then ``REPS`` passes over every MBConv.
Reads nothing in a cell without a MaxViT table or on a program without
the function."""
import torch

from benchmark import flops_maxvit

REPS = 3


def read(ctx):
    drive = ctx["drive"]
    if (drive.rate != "train_slices_per_s" or ctx["device"].type != "cuda" or not ctx["peak"]
            or getattr(drive, "mv", None) is None):
        return None
    try:
        from pd_fusion_torch.nn.maxvit import depthwise_conv
    except ImportError:
        return None

    dev, n, a = ctx["device"], drive.bs * drive.L, drive.mv
    gen = torch.Generator(device=dev).manual_seed(drive.seed % 2**63)
    convs = []
    for mid, r_in, r_out, stride in flops_maxvit.mbconvs(a, drive.size):
        x = torch.randn(n, mid, r_in, r_in, generator=gen, device=dev)
        x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
        w = (torch.randn(mid, 1, 3, 3, generator=gen, device=dev) * 0.1).requires_grad_(True)
        g = torch.randn(n, mid, r_out, r_out, generator=gen, device=dev)
        convs.append((x, w, stride, g.contiguous(memory_format=torch.channels_last)))

    def once():
        for x, w, stride, g in convs:
            torch.autograd.grad(depthwise_conv(x, w, stride), [x, w], grad_outputs=g)

    once()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(REPS):
        once()
    end.record()
    torch.cuda.synchronize(dev)
    seconds = start.elapsed_time(end) / 1e3 / REPS
    peak = ctx["peak"]
    bound = sum(max(f / peak["float32_flops"], b / peak["hbm_bytes_per_s"])
                for f, b in flops_maxvit.depthwise(a, drive.size, n))
    return 100.0 * bound / seconds
