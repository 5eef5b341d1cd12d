"""bn_kernel.train: calls of the backbone's fused train-mode BN in a
training step, over ``trainer:steps``, in a cell that reports
``train_slices_per_s``. A call is one forward or backward. On a CUDA device
it reads ``backbone:bn_kernel``, the calls that launched the kernels, so a
run whose BN did not engage them reads nothing; on the CPU, where the
program takes the plain version, it reads ``backbone:bn_plain``. A
ResNet-50 unfrozen step makes 158 (53 forwards, 52 rematerialized, 53
backwards), ResNet-18's 59, a frozen ResNet-50 step's 53. Reads nothing
from a program without the counter (one whose BN is torch ops, or a Swin
backbone, which has no BN)."""
from benchmark.harness import program_spans

RATE = "train_slices_per_s"


def read(ctx):
    on_card = getattr(ctx["device"], "type", None) == "cuda"
    name = "backbone:bn_kernel" if on_card else "backbone:bn_plain"
    return program_spans.counter_ratio(ctx, RATE, name, "trainer:steps")
