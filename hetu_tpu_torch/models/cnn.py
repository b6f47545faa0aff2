"""CNNs (counterpart of ``hetu_tpu.models.cnn``): the CIFAR-10 convnet
and the CIFAR ResNets, NCHW, on ``torch.nn.functional``'s convolutions.
Reshapes leave the batch axis free (-1), so the graph's micro-batches run
the same ops."""
from __future__ import annotations

from typing import Sequence

from ..nn import (BatchNorm2d, Conv2d, Linear, MaxPool2d, Module, ModuleList,
                  ReLU, Sequential)
from ..ops import functional as ops


class SimpleCNN(Module):
    """LeNet-style CIFAR-10 net."""

    def __init__(self, num_classes: int = 10, in_channels: int = 3):
        super().__init__()
        self.features = Sequential(
            Conv2d(in_channels, 32, kernel_size=3, padding=1), ReLU(),
            Conv2d(32, 32, kernel_size=3, padding=1), ReLU(),
            MaxPool2d(2),
            Conv2d(32, 64, kernel_size=3, padding=1), ReLU(),
            Conv2d(64, 64, kernel_size=3, padding=1), ReLU(),
            MaxPool2d(2),
        )
        self.fc1 = Linear(64 * 8 * 8, 256)
        self.fc2 = Linear(256, num_classes)

    def forward(self, x, labels=None):
        h = self.features(x)
        h = ops.reshape(h, (-1, h.shape[1] * h.shape[2] * h.shape[3]))
        logits = self.fc2(ops.relu(self.fc1(h)))
        if labels is None:
            return logits
        return ops.softmax_cross_entropy(logits, labels)


class BasicBlock(Module):
    """ResNet v1 basic block (3x3 + 3x3, identity or projection
    shortcut)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_ch, out_ch, kernel_size=3, stride=stride,
                            padding=1, bias=False)
        self.bn1 = BatchNorm2d(out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, kernel_size=3, padding=1,
                            bias=False)
        self.bn2 = BatchNorm2d(out_ch)
        if stride != 1 or in_ch != out_ch:
            self.shortcut = Sequential(
                Conv2d(in_ch, out_ch, kernel_size=1, stride=stride,
                       bias=False),
                BatchNorm2d(out_ch))
        else:
            self.shortcut = None

    def forward(self, x):
        h = ops.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        sc = self.shortcut(x) if self.shortcut is not None else x
        return ops.relu(h + sc)


class ResNet(Module):
    """CIFAR ResNet (18 layers by default: stages (2, 2, 2, 2))."""

    def __init__(self, num_classes: int = 10,
                 stages: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 in_channels: int = 3):
        super().__init__()
        if len(stages) > len(widths):
            raise ValueError(f"need a width per stage ({len(stages)} stages, "
                             f"{len(widths)} widths)")
        self.stem = Sequential(
            Conv2d(in_channels, widths[0], kernel_size=3, padding=1,
                   bias=False),
            BatchNorm2d(widths[0]), ReLU())
        blocks = []
        in_ch = widths[0]
        for si, (n, w) in enumerate(zip(stages, widths)):
            for bi in range(n):
                blocks.append(BasicBlock(in_ch, w,
                                         2 if (si > 0 and bi == 0) else 1))
                in_ch = w
        self.blocks = ModuleList(blocks)
        self.head = Linear(in_ch, num_classes)

    def forward(self, x, labels=None):
        h = self.stem(x)
        for blk in self.blocks:
            h = blk(h)
        h = ops.reduce_mean(h, axis=(2, 3))     # global average pool
        logits = self.head(h)
        if labels is None:
            return logits
        return ops.softmax_cross_entropy(logits, labels)


def resnet18(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(num_classes, stages=(2, 2, 2, 2), **kw)


def resnet34(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(num_classes, stages=(3, 4, 6, 3), **kw)
