"""Torch helpers (port of ``pd_fusion/utils/torch_utils.py``).

``get_torch_device`` is ``utils/device.py::get_device``: the card unless
the CPU is asked for, raising where there is no card. The JAX package's
shim prefers CUDA, then MPS, then the CPU; the port has no fallback off
the card. ``build_torch_resnet18`` is the JAX package's, unchanged.
"""


def get_torch_device():
    from pd_fusion_torch.utils.device import get_device

    return get_device()


def build_torch_resnet18():
    """torchvision-resnet18-shaped torch module with matching state_dict
    names (torchvision is installed on neither machine). The torch side
    of embed-path comparisons; weights are whatever torch's default init
    draws — seed before construction for determinism."""
    import torch
    import torch.nn as nn

    class BasicBlock(nn.Module):
        def __init__(self, cin, cout, stride=1):
            super().__init__()
            self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(cout)
            self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(cout)
            self.downsample = None
            if stride != 1 or cin != cout:
                self.downsample = nn.Sequential(
                    nn.Conv2d(cin, cout, 1, stride, bias=False), nn.BatchNorm2d(cout)
                )

        def forward(self, x):
            idt = x if self.downsample is None else self.downsample(x)
            out = torch.relu(self.bn1(self.conv1(x)))
            return torch.relu(self.bn2(self.conv2(out)) + idt)

    class TorchResNet18(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
            self.bn1 = nn.BatchNorm2d(64)
            self.maxpool = nn.MaxPool2d(3, 2, 1)
            self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
            self.layer2 = nn.Sequential(BasicBlock(64, 128, 2), BasicBlock(128, 128))
            self.layer3 = nn.Sequential(BasicBlock(128, 256, 2), BasicBlock(256, 256))
            self.layer4 = nn.Sequential(BasicBlock(256, 512, 2), BasicBlock(512, 512))
            self.avgpool = nn.AdaptiveAvgPool2d(1)

        def forward(self, x):
            x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
            for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
                x = layer(x)
            return self.avgpool(x).flatten(1)

    return TorchResNet18()
