"""The bf16 weight image of the tensor-core kernels
(``neuralsim_tpu_torch.kernels.raymarch.pack_wgmma_weights``).

nerf_march.cu and render_tile.cu stream it chunk by chunk into shared
memory and read each chunk through a K-major wgmma descriptor with 128-byte
swizzle. These tests read the image back through that layout, written out
here on its own: in a chunk of N rows, input k of output column n lies at
byte n*128 + ((k // 8) ^ (n % 8))*16 + (k % 8)*2."""

import numpy as np
import pytest
import torch

from neuralsim_tpu_torch.config import NeRFNetConfig
from neuralsim_tpu_torch.kernels import raymarch as rm
from neuralsim_tpu_torch.models.nerf import init_nerf_params, round_to

SMALL = dict(netdepth=4, netwidth=32, netdepth_fine=4, netwidth_fine=32, skips=(2,))


def _segments(params, net):
    """The [K, N] kernel slices in the order the kernels consume them."""
    depth = rm._depth(params)
    segs = [params["pts_0_kernel"]]
    for i in range(1, depth):
        k = params[f"pts_{i}_kernel"]
        segs += [k[:net.input_ch], k[net.input_ch:]] if (i - 1) in net.skips else [k]
    views = params["views_0_kernel"]
    n_feature = views.shape[0] - net.input_ch_views
    return segs + [params["feature_kernel"], views[:n_feature], views[n_feature:]]


def _read_back(image: np.ndarray, offset: int, k: int, n: int):
    """The [ceil(k/64)*64, n] matrix stored at byte `offset` of the image,
    and the bytes it takes."""
    chunks = -(-k // 64)
    kk, nn = np.meshgrid(np.arange(64), np.arange(n), indexing="ij")
    out = np.zeros((chunks * 64, n), np.float32)
    for c in range(chunks):
        byte = offset + c * n * 128 + nn * 128 + ((kk // 8) ^ (nn % 8)) * 16 + (kk % 8) * 2
        out[c * 64:(c + 1) * 64] = image[byte // 2]
    return out, chunks * n * 128


@pytest.mark.parametrize("small", [False, True], ids=["default_8x256", "small_4x32"])
def test_image_reads_back_as_the_bf16_weights(small):
    net = NeRFNetConfig(**SMALL) if small else NeRFNetConfig()
    params = init_nerf_params(net, generator=torch.Generator().manual_seed(0))
    packed = rm.pack_wgmma_weights(params, net)
    assert packed.dtype == torch.bfloat16 and packed.dim() == 1
    image = packed.to(torch.float32).numpy()
    offset = 0
    for w in _segments(params, net):
        k, n = w.shape
        got, nbytes = _read_back(image, offset, k, n)
        np.testing.assert_array_equal(got[:k], round_to(w, torch.bfloat16).numpy())
        assert not got[k:].any()                   # padded input rows are zero
        offset += nbytes
    assert offset == packed.numel() * 2
    assert offset == rm.wgmma_bytes(net.netdepth, len(net.skips), net.netwidth)
    if not small:
        # 34 chunks of [256][64] and 5 of [128][64] bf16
        assert offset == (34 * 256 + 5 * 128) * 64 * 2 == 1_196_032


def test_packed_weights_are_cached_per_weight_set():
    net = NeRFNetConfig(**SMALL)
    params = init_nerf_params(net, generator=torch.Generator().manual_seed(1))
    depth = rm._depth(params)
    first = rm._packed_weights(params, net, depth, "test")
    assert rm._packed_weights(params, net, depth, "test") is first
    params["pts_1_kernel"].mul_(2.0)                # an in-place update packs again
    again = rm._packed_weights(params, net, depth, "test")
    assert again is not first
    torch.testing.assert_close(again, rm.pack_wgmma_weights(params, net), rtol=0, atol=0)
