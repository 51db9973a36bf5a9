"""Feature Pyramid Network P3-P7 for RetinaNet (a copy of
``neuralsim_tpu_torch/models/fpn.py``).

Lateral 1x1 + top-down nearest upsample + output 3x3 over (C3, C4, C5),
with the RetinaNet extra levels P6 = 3x3/s2 on C5 (or P5) and P7 = 3x3/s2
on relu(P6): detectron2's ``LastLevelP6P7(in_feature="res5")`` of the
reference's retinanet_R_50_FPN_3x config (``neural_sim_main.py:598``).
Layout is NCHW.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from bench_port.reference.resnet import conv


def upsample_nearest_to(x: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    """Nearest-neighbour upsample of [N, C, h, w] to the lateral's own size
    by the index rule (i * h) // h_out. With ceil(side / stride) backbone
    maps the lateral is not always twice the coarser map (at 100 px C4 is
    7 and C5 4); the integer rule picks the rows the JAX package picks,
    where F.interpolate's float scale can pick another."""
    h, w = x.shape[-2:]
    ri = torch.clamp(torch.arange(h_out, device=x.device) * h // h_out, max=h - 1)
    ci = torch.clamp(torch.arange(w_out, device=x.device) * w // w_out, max=w - 1)
    return x[:, :, ri][:, :, :, ci]


class FPN(nn.Module):
    """``p6_source``: "c5" (2048 channels, detectron2's layout and the
    reference's) or "p5" (256 channels, torchvision's
    LastLevelP6P7(256, 256))."""

    def __init__(self, out_channels: int = 256, p6_source: str = "c5",
                 in_channels=(512, 1024, 2048)):
        super().__init__()
        if p6_source not in ("c5", "p5"):
            raise ValueError(f"p6_source must be 'c5' or 'p5', got {p6_source!r}")
        self.p6_source = p6_source
        c3, c4, c5 = in_channels
        self.lateral5 = conv(c5, out_channels, 1)
        self.lateral4 = conv(c4, out_channels, 1)
        self.lateral3 = conv(c3, out_channels, 1)
        self.output5 = conv(out_channels, out_channels, 3, padding=1)
        self.output4 = conv(out_channels, out_channels, 3, padding=1)
        self.output3 = conv(out_channels, out_channels, 3, padding=1)
        self.p6 = conv(c5 if p6_source == "c5" else out_channels, out_channels, 3, 2, padding=1)
        self.p7 = conv(out_channels, out_channels, 3, 2, padding=1)

    def forward(self, c3, c4, c5) -> List[torch.Tensor]:
        l5 = self.lateral5(c5)
        l4 = self.lateral4(c4)
        l3 = self.lateral3(c3)
        t4 = l4 + upsample_nearest_to(l5, *l4.shape[-2:])
        t3 = l3 + upsample_nearest_to(t4, *l3.shape[-2:])
        p5 = self.output5(l5)
        p4 = self.output4(t4)
        p3 = self.output3(t3)
        p6 = self.p6(c5 if self.p6_source == "c5" else p5)
        p7 = self.p7(F.relu(p6))
        return [p3, p4, p5, p6, p7]
