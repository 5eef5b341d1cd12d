"""window_attn_roofline.train: the program's window attention of every
block (``nn/swin.py::window_attention``: the scaled scores, the relative
position bias and the shift mask, the softmax and the weighted values),
forward and backward at the training step's shapes, against its roofline
bound, in percent: the sum over the blocks of max(FLOPs / the card's
float32 peak, unavoidable bytes / its memory bandwidth), over the device
time between CUDA events. FLOPs are the two products and their four
gradient products; bytes are q, k, v, the output, the bias table and the
gradient of each, read or written once (``flops_swin.window_attention``):
no implementation can pass 100%.

Times the program's function after the window on random q, k, v of each
block's shape ([B * L * windows, heads, M^2, head dim]) with the block's
own bias table and the stage's mask, then ``torch.autograd.grad`` of the
output against a fixed random gradient over q, k, v and the table. One
warm-up, then ``REPS`` passes over every block. Reads nothing in a cell
without a Swin table or on a program without the function."""
import torch

from benchmark import flops_swin
from benchmark.reference import swin

REPS = 3


def read(ctx):
    drive = ctx["drive"]
    if (drive.rate != "train_slices_per_s" or ctx["device"].type != "cuda" or not ctx["peak"]
            or getattr(drive, "sw", None) is None):
        return None
    try:
        from pd_fusion_torch.nn.swin import shift_mask, window_attention
    except ImportError:
        return None

    dev, n, a = ctx["device"], drive.bs * drive.L, drive.sw
    gen = torch.Generator(device=dev).manual_seed(drive.seed % 2**63)
    blocks = []
    layers = drive.model.backbone_params["layers"]
    for (res, C, window, shift), layer, heads in zip(swin.stages(a, drive.size),
                                                     layers, a.heads):
        N, nW = window * window, (res // window) ** 2
        for j, block in enumerate(layer["blocks"]):
            shape = (n * nW, heads, N, C // heads)
            qkv = [torch.randn(shape, generator=gen, device=dev).requires_grad_(True)
                   for _ in range(3)]
            table = block["attn"]["relative_position_bias_table"].detach().requires_grad_(True)
            mask = shift_mask(res, window, shift, dev) if j % 2 else None
            blocks.append((qkv, table, window, mask, torch.randn(shape, generator=gen,
                                                                 device=dev)))

    def once():
        for qkv, table, window, mask, g in blocks:
            o = window_attention(*qkv, table, window, mask)
            torch.autograd.grad(o, qkv + [table], grad_outputs=g)

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
                for f, b in flops_swin.window_attention(a, drive.size, n))
    return 100.0 * bound / seconds
