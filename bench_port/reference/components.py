"""On-device 8-connected components for auto-annotation (a copy of
``neuralsim_tpu_torch/ops/components.py``).

  - ``label_components``: each foreground pixel starts with its row-major
    index; segmented min-scans along rows and columns (reset at
    background) spread the component minimum along mask runs, and one
    masked diagonal min step links diagonal neighbours. The loop runs to a
    fixpoint, which every pixel reaches with the minimum row-major index
    of its 8-connected component: 2-3 iterations for convex blobs. Each
    iteration reads one flag on the host.
  - ``component_boxes``: per-component boxes by scatter-min/max of pixel
    coordinates into label bins, ranked by box area (w*h, the host
    annotator's key) with ties to the lower bin, i.e. first-pixel order.

Everything is integer or boolean downstream of the mask, so no gradient
reaches the loop.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_port.reference.render import top_k_indices


def _segmented_min_scan(v: torch.Tensor, reset: torch.Tensor, dim: int,
                        reverse: bool = False) -> torch.Tensor:
    """Min-scan of int64 ``v`` along ``dim`` that restarts at each ``reset``
    pixel (background). ``seg`` counts the resets up to each pixel; shifting
    every segment below all earlier ones (``v - seg * big``, with ``big``
    above any value) makes one cummin restart at each segment."""
    if reverse:
        v, reset = v.flip(dim), reset.flip(dim)
    seg = torch.cumsum(reset.to(torch.int64), dim=dim)
    big = v.amax() + 1
    out = torch.cummin(v - seg * big, dim=dim).values + seg * big
    return out.flip(dim) if reverse else out


def _shift2d(x: torch.Tensor, dy: int, dx: int, fill: int) -> torch.Tensor:
    """Shift [N, H, W] by (dy, dx), filling vacated pixels with ``fill`` (no
    wraparound: a wrapped label would leak across image edges)."""
    _, h, w = x.shape
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    return p[:, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w]


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """8-connected component labels of a [N, H, W] bool mask.

    Returns int32 [N, H, W]: each foreground pixel carries the minimum
    row-major index of its component; background pixels carry H*W.
    """
    mask = mask.detach().bool()
    _, h, w = mask.shape
    big = h * w
    idx = torch.arange(h * w, dtype=torch.int64, device=mask.device).reshape(1, h, w)
    lab = torch.where(mask, idx, big)
    reset = ~mask
    while True:
        new = _segmented_min_scan(lab, reset, dim=2)
        new = _segmented_min_scan(new, reset, dim=2, reverse=True)
        new = _segmented_min_scan(new, reset, dim=1)
        new = _segmented_min_scan(new, reset, dim=1, reverse=True)
        # one masked diagonal-neighbour min links 8-connectivity; the next
        # iteration's scans spread it through the component
        masked = torch.where(mask, new, big)
        for dy, dx in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
            new = torch.minimum(new, _shift2d(masked, dy, dx, big))
        new = torch.where(mask, new, big)
        changed = bool((new != lab).any())
        lab = new
        if not changed:
            return lab.to(torch.int32)


def component_boxes(mask: torch.Tensor, max_boxes: int):
    """Top-``max_boxes`` 8-connected component boxes of [N, H, W] masks.

    Returns (boxes [N, K, 4] float32 XYXY with the host path's x + w
    convention, valid [N, K] bool). Slot order: box area (w*h) descending,
    ties in first-pixel (minimum row-major index) order, so slot 0 is the
    host auto_annotate's largest-component box for any number of
    components.
    """
    n, h, w = mask.shape
    hw = h * w
    lab = label_components(mask).reshape(n, hw).to(torch.int64)
    pix = torch.arange(hw, device=mask.device)
    rows = (pix // w).expand(n, hw)
    cols = (pix % w).expand(n, hw)

    # bin = the component's minimum pixel index; background lands in the
    # extra bin hw, which is cut off after the scatter
    fg = lab < hw

    def scatter(values, fill, reduce):
        out = torch.full((n, hw + 1), fill, dtype=torch.int64, device=mask.device)
        return out.scatter_reduce(1, lab, torch.where(fg, values, fill), reduce)[:, :hw]

    minr, minc = scatter(rows, hw, "amin"), scatter(cols, hw, "amin")
    maxr, maxc = scatter(rows, -1, "amax"), scatter(cols, -1, "amax")

    present = maxr >= 0
    area = (maxr - minr + 1) * (maxc - minc + 1)
    top = top_k_indices(torch.where(present, area, -1), max_boxes)        # [N, K]

    def gather(t):
        return torch.gather(t, 1, top)

    valid = gather(present)
    boxes = torch.stack([gather(minc), gather(minr), gather(maxc) + 1, gather(maxr) + 1],
                        dim=-1).to(torch.float32)
    return torch.where(valid[..., None], boxes, torch.zeros_like(boxes)), valid
