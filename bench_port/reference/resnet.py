"""ResNet-50 backbone with frozen batch-norm (a copy of
``neuralsim_tpu_torch/models/resnet.py``).

The reference's detector backbone is detectron2's ResNet-50 with
``FREEZE_AT=6`` (``optimization/neural_sim_main.py:617``) and BatchNorm
layers that are always FrozenBN. ``FrozenBN`` is a pure affine scale/bias
whose two vectors are parameters of the ``backbone`` subtree, as in the
JAX package; ``detector.trainer.split_trainable`` freezes them with the
rest of the backbone when ``freeze_backbone`` is set.

Layout is NCHW. Modules and parameters carry the Flax tree's names
(``res2_block0.conv1.weight``), so ``models.convert_retinanet`` maps the
two with one rule per parameter kind. Stride sits on the 3x3 conv
(torchvision convention) unless ``stride_in_1x1`` (detectron2 caffe style).
Padding follows the Flax modules: explicit 1 on the 3x3 convs, 3 on the
stem's 7x7, and SAME on the 1x1 convs, which is 0 for a 1x1 kernel.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBN(nn.Module):
    """BatchNorm with folded statistics: y = x * scale + bias."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return x * self.scale[:, None, None] + self.bias[:, None, None]


def conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
         bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 stride_in_1x1: bool = False):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = conv(cin, features, 1, s1, bias=False)
        self.bn1 = FrozenBN(features)
        self.conv2 = conv(features, features, 3, s3, padding=1, bias=False)
        self.bn2 = FrozenBN(features)
        self.conv3 = conv(features, features * 4, 1, bias=False)
        self.bn3 = FrozenBN(features * 4)
        if cin != features * 4 or stride != 1:
            self.downsample_conv = conv(cin, features * 4, 1, stride, bias=False)
            self.downsample_bn = FrozenBN(features * 4)
        else:
            self.downsample_conv = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample_conv is not None:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + x)


class ResNet50(nn.Module):
    """Returns (C3, C4, C5) feature maps at strides (8, 16, 32)."""

    WIDTHS = (64, 128, 256, 512)

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 6, 3),
                 stride_in_1x1: bool = False):
        super().__init__()
        self.stem_conv = conv(3, 64, 7, 2, padding=3, bias=False)
        self.stem_bn = FrozenBN(64)
        self.stages = []
        cin = 64
        for stage, (blocks, width) in enumerate(zip(stage_blocks, self.WIDTHS)):
            names = []
            for b in range(blocks):
                name = f"res{stage + 2}_block{b}"
                stride = 1 if stage == 0 or b > 0 else 2
                self.add_module(name, Bottleneck(cin, width, stride, stride_in_1x1))
                names.append(name)
                cin = width * 4
            self.stages.append(names)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        # the padding is -inf, as flax's max_pool pads
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        _, c3, c4, c5 = outs
        return c3, c4, c5
