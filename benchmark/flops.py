"""Model FLOPs of the cells' work, from the published layer tables.

A convolution's forward is ``2 * Cin * Cout * k^2 * Ho * Wo`` FLOPs an
image, a linear's ``2 * in * out`` a row (a multiply and an add each). A
training step counts the forward F, the weight gradients F and the data
gradients F, less the stem's data gradient (its input, the augmented
slices, needs none): ``3F - F_stem`` an image for the backbone, three
forwards for the head's linears. Recomputation (the program keeps no
block activations and runs each block's forward again in the backward
pass) is not counted: these are the model's FLOPs, not the hardware's.
Pooling, softmax, normalization and elementwise work are not counted.
"""
from benchmark.reference import resnet


def backbone_forward(arch: str, size: int):
    """-> (FLOPs of one image's forward, of which the stem's)."""
    total = stem = 0
    h = block_in = size
    for c in resnet.convs(arch):
        if c.name == "conv1":
            h_in = size
        elif c.name.endswith("downsample.0"):
            h_in = block_in
        elif c.name.endswith(".conv1"):
            h_in = block_in = h
        else:
            h_in = h
        h_out = resnet.conv_out(h_in, c)
        f = 2 * c.cin * c.cout * c.k * c.k * h_out * h_out
        total += f
        if c.name == "conv1":
            stem = f
            h_out = (h_out + 2 - 3) // 2 + 1  # the 3x3/2 max pool after the stem
        if not c.name.endswith("downsample.0"):
            h = h_out
    return total, stem


def head_forward(D: int, H: int, A: int, L: int) -> int:
    """One bag of ``L`` slices through the gated attention head's linears."""
    per_slice = 2 * (D * H + 2 * H * A + A)
    return L * per_slice + 2 * H


def train_step(arch: str, size: int, B: int, L: int, H: int, A: int) -> int:
    f, stem = backbone_forward(arch, size)
    return B * L * (3 * f - stem) + 3 * B * head_forward(resnet.emb_dim(arch), H, A, L)


def backbone_train(arch: str, size: int, n: int) -> int:
    f, stem = backbone_forward(arch, size)
    return n * (3 * f - stem)


def predict_pass(arch: str, size: int, B: int, L: int, H: int, A: int) -> int:
    """One TTA pass over ``B`` bags: the forward alone."""
    f, _ = backbone_forward(arch, size)
    return B * L * f + B * head_forward(resnet.emb_dim(arch), H, A, L)
