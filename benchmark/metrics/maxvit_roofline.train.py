"""maxvit_roofline.train: the MaxViT backbone's forward and both gradients
at the training step's shapes, as model FLOPs
(``flops_maxvit.backbone_train``: 3F less the first convolution's data
gradient, an image; no recompute counted), over their device time and the
card's float32 peak, in percent.

Times the program's own calls between CUDA events after the window:
``maxvit_apply_train`` on the step's ``B * L`` images with every image
weighted, then ``torch.autograd.grad`` of a fixed random projection of the
embeddings over the trainable leaves alone, as the step takes them (the
input needs no gradient). One warm-up, then ``REPS`` calls. Reads nothing
in a cell without a MaxViT table or on a program without
``nn/maxvit.py``."""
import torch

from benchmark import flops_maxvit

REPS = 3


def read(ctx):
    drive = ctx["drive"]
    if (drive.rate != "train_slices_per_s" or ctx["device"].type != "cuda" or not ctx["peak"]
            or getattr(drive, "mv", None) is None):
        return None
    try:
        from pd_fusion_torch.nn.maxvit import maxvit_apply_train
    except ImportError:
        return None
    from pd_fusion_torch.models import mil_attention_finetune as mft

    dev, n = ctx["device"], drive.bs * drive.L
    gen = torch.Generator(device=dev).manual_seed(drive.seed % 2**63)
    x = torch.rand(n, drive.size, drive.size, 3, generator=gen, device=dev) * 4.0 - 2.0
    weight = torch.ones(n, device=dev)
    params = drive.model.backbone_params
    proj = None

    def once():
        nonlocal proj
        leaves = [t.detach().requires_grad_(True) for t in mft.trainable_leaves(params)]
        emb, _ = maxvit_apply_train(mft.replace_trainable(params, leaves), x, drive.arch,
                                    sample_weight=weight)
        if proj is None:
            proj = torch.randn(emb.shape, generator=gen, device=dev)
        torch.autograd.grad(torch.sum(emb * proj), leaves)

    once()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(REPS):
        once()
    end.record()
    torch.cuda.synchronize(dev)
    seconds = start.elapsed_time(end) / 1e3 / REPS
    work = flops_maxvit.backbone_train(drive.mv, drive.size, n)
    return 100.0 * work / seconds / ctx["peak"]["float32_flops"]
