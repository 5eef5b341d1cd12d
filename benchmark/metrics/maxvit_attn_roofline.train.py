"""maxvit_attn_roofline.train: the program's attention of every MaxViT
block's two layers, block and grid (``nn/swin.py::window_attention``: the
scaled scores, the relative position bias, the softmax and the weighted
values; both partitions give it groups of ``P^2`` tokens), forward and
backward at the training step's shapes, against its roofline bound, in
percent: the sum over the layers of max(FLOPs / the card's float32 peak,
unavoidable bytes / its memory bandwidth), over the device time between
CUDA events. FLOPs are the two products and their four gradient products;
bytes are q, k, v, the output, the bias table and the gradient of each,
read or written once (``flops_maxvit.attention``): no implementation can
pass 100%.

Times the program's function after the window on random q, k, v of each
stage's shape ([B * L * groups, heads, P^2, head dim]; one set a stage,
as block and grid attention take the same shape) with each layer's own
bias table and no mask, then ``torch.autograd.grad`` of the output
against a fixed random gradient over q, k, v and the table. One warm-up,
then ``REPS`` passes over every layer. Reads nothing in a cell without a
MaxViT table or on a program without the functions."""
import torch

from benchmark import flops_maxvit
from benchmark.reference import maxvit

REPS = 3


def read(ctx):
    drive = ctx["drive"]
    if (drive.rate != "train_slices_per_s" or ctx["device"].type != "cuda" or not ctx["peak"]
            or getattr(drive, "mv", None) is None):
        return None
    try:
        from pd_fusion_torch.nn.swin import window_attention
        import pd_fusion_torch.nn.maxvit  # noqa: F401
    except ImportError:
        return None

    dev, n, a = ctx["device"], drive.bs * drive.L, drive.mv
    gen = torch.Generator(device=dev).manual_seed(drive.seed % 2**63)
    P = a.partition
    stages = []
    for (res, _, C, _), stage in zip(maxvit.stages(a, drive.size),
                                     drive.model.backbone_params["stages"]):
        shape = (n * (res // P) ** 2, C // a.head_dim, P * P, a.head_dim)
        qkv = [torch.randn(shape, generator=gen, device=dev).requires_grad_(True)
               for _ in range(3)]
        tables = [layer[part]["attn"]["relative_position_bias_table"].detach()
                  .requires_grad_(True) for layer in stage for part in ("window", "grid")]
        stages.append((qkv, tables, torch.randn(shape, generator=gen, device=dev)))

    def once():
        for qkv, tables, g in stages:
            for table in tables:
                o = window_attention(*qkv, table, P, None)
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
                for f, b in flops_maxvit.attention(a, drive.size, n))
    return 100.0 * bound / seconds
