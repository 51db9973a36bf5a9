"""The yardstick's arithmetic: work of the NeRF MLP from its shapes, the
card's published peaks, and the least time a kernel call could take.

Copied from the repository's ``chip_smoke.py`` (``macs_per_point``,
``work``, ``bound``, ``peaks_for``), so that a change to the program cannot
move it. Every count follows from a configuration's widths and a call's
shape, never from what the program reports.
"""

from __future__ import annotations

# Published dense peaks (NVIDIA data sheets): FP32 on the CUDA cores, bf16
# on the tensor cores, memory bytes/s; all at the card's full power limit
PEAKS = {
    "H100 SXM": {"float32": 67e12, "bfloat16": 989e12, "bytes": 3.35e12},
    "H100 PCIe": {"float32": 51e12, "bfloat16": 756e12, "bytes": 2.0e12},
    "H100 NVL": {"float32": 60e12, "bfloat16": 835e12, "bytes": 3.9e12},
}


def peaks_for(card_name: str):
    """(variant, peaks) for a card name as ``torch.cuda.get_device_name``
    gives it; an H100 that names no other variant is the SXM part."""
    key = ("H100 PCIe" if "PCIe" in card_name else
           "H100 NVL" if "NVL" in card_name else "H100 SXM")
    return key, PEAKS[key]


def macs_per_point(net: dict) -> int:
    """Multiply-adds of one sample through the NeRF MLP with view
    directions: the trunk with its skips, the feature, alpha, view and rgb
    layers. ``net`` holds the NeRFNetConfig fields."""
    w, d = net["netwidth"], net["netdepth"]
    x_ch = 3 + 6 * net["multires"]
    d_ch = 3 + 6 * net["multires_views"]
    macs = x_ch * w + (d - 1) * w * w + len(net["skips"]) * x_ch * w
    return macs + w * w + w + (w + d_ch) * (w // 2) + (w // 2) * 3


def march_work(net: dict, n: int, s: int, weight_bytes: int):
    """(FLOP, bytes) of one ray-march call (kernel 1) on n rays x s
    samples: each input read once (origins, directions, view directions,
    depths, the weights), each output written once (sigma and rgb)."""
    m = n * s
    flop = 2.0 * macs_per_point(net) * m
    nbytes = 3 * n * 3 * 4 + m * 4 + 4 * m * 4 + weight_bytes
    return flop, nbytes


def weight_bytes(net: dict, dtype: str) -> int:
    """Bytes of one MLP's weights in the dtype the kernel reads them."""
    w, d = net["netwidth"], net["netdepth"]
    x_ch = 3 + 6 * net["multires"]
    d_ch = 3 + 6 * net["multires_views"]
    params = (x_ch * w + w + (d - 1) * (w * w + w) + len(net["skips"]) * x_ch * w
              + w * w + w + w + 1 + (w + d_ch) * (w // 2) + w // 2 + (w // 2) * 3 + 3)
    return params * (2 if dtype == "bfloat16" else 4)


def bound_s(flop: float, nbytes: float, peak_flops: float, peak_bytes: float) -> float:
    """The least seconds the card could take: the larger of the operations
    bound and the bytes bound."""
    return max(flop / peak_flops, nbytes / peak_bytes)
