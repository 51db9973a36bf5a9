"""The bf16 weight image of the tensor-core kernels
(``neuralsim_tpu_torch.kernels.raymarch.pack_wgmma_weights``).

Every bf16 kernel (nerf_march.cu, render_tile.cu and nerf_mlp.cu's three
stages) streams it chunk by chunk into shared memory and reads each chunk
through a K-major wgmma descriptor with 128-byte swizzle. These tests read the image back through that layout, written out
here on its own: in a chunk of N rows, input k of output column n lies at
byte n*128 + ((k // 8) ^ (n % 8))*16 + (k % 8)*2."""

import numpy as np
import pytest
import torch

from neuralsim_tpu_torch.config import NeRFNetConfig
from neuralsim_tpu_torch.kernels import raymarch as rm
from neuralsim_tpu_torch.models.nerf import init_nerf_params, round_to
from tests.test_torch_net_shapes import _FakeMarchLibrary

SMALL = dict(netdepth=4, netwidth=32, netdepth_fine=4, netwidth_fine=32, skips=(2,))
NETS = {"default_8x256": dict(), "small_4x32": SMALL,
        # a 512-wide trunk: each chunk holds both warpgroups' column halves
        "w512": dict(netdepth=4, netwidth=512, netdepth_fine=4, netwidth_fine=512, skips=(2,)),
        # three x_pe chunks and two d_pe chunks (147 / 75 channels), and four
        # and two (255 / 123)
        "pe24_12": dict(netdepth=4, netdepth_fine=4, skips=(2,), multires=24, multires_views=12),
        "pe42_20": dict(netdepth=4, netdepth_fine=4, skips=(2,), multires=42, multires_views=20)}


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


@pytest.mark.parametrize("name", list(NETS))
def test_image_reads_back_as_the_bf16_weights(name):
    net = NeRFNetConfig(**NETS[name])
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
    assert offset == rm.wgmma_bytes(net.netdepth, len(net.skips), net.netwidth, net.input_ch,
                                    net.input_ch_views)
    if name == "default_8x256":
        # 34 chunks of [256][64] and 5 of [128][64] bf16
        assert offset == (34 * 256 + 5 * 128) * 64 * 2 == 1_196_032


class _FakeMlpLibrary(_FakeMarchLibrary):
    """Stands in for the built nerf_mlp library: the CUDA headers' shape
    limits and chunk plans (``_FakeMarchLibrary``), and a record of each
    call of the C entry."""

    def nerf_mlp(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("bf16, name", [(True, "small_4x32"), (False, "small_4x32"),
                                        (True, "w512")],
                         ids=["bf16_wgmma", "f32", "bf16_wgmma_w512"])
def test_packed_weights_are_cached_per_weight_set(bf16, name):
    """One preparation per weight set and dtype: weights padded to the core
    width (bf16 kernels rounded) and the chunks of the core the dtype runs
    (wgmma in bf16, the FP32 core in float32); an in-place update of a
    weight prepares again."""
    net = NeRFNetConfig(**NETS[name])
    params = init_nerf_params(net, generator=torch.Generator().manual_seed(1))
    depth = rm._depth(params)
    lib = _FakeMlpLibrary()
    first = rm._packed_weights(params, net, depth, bf16, lib, "test")
    assert rm._packed_weights(params, net, depth, bf16, lib, "test")[1] is first[1]
    params["pts_1_kernel"].mul_(2.0)                # an in-place update packs again
    weights, again, _ = rm._packed_weights(params, net, depth, bf16, lib, "test")
    assert again is not first[1]
    padded = rm.pad_params(params, net, rm.core_width(net.netwidth))
    if bf16:
        padded = {k: round_to(v, torch.bfloat16) if k.endswith("kernel") else v
                  for k, v in padded.items()}
    for key, w in zip(rm.param_keys(depth), weights):
        torch.testing.assert_close(w, padded[key], rtol=0, atol=0, msg=key)
    pack = rm.pack_wgmma_weights if bf16 else rm.pack_f32_weights
    torch.testing.assert_close(again, pack(padded, net), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("wrapper, kind", [
    ("fused_nerf_mlp_widepe", "widepe"), ("fused_nerf_mlp", "encoded"),
    ("fused_nerf_mlp_pe", "pe")])
def test_mlp_launch_passes_packed_weights_to_the_wgmma_stages(monkeypatch, wrapper, kind,
                                                             dtype):
    """On the kernel route, nerf_mlp's C entry gets the packed bf16 weights
    for every stage in bf16, the true-cos stage of fused_nerf_mlp_pe
    included (the very image that pack_wgmma_weights makes: all three run
    on the tensor cores), and the FP32 core's float32 chunks
    (pack_f32_weights) in float32; its argument count is the one the
    library is bound with."""
    net = NeRFNetConfig(**SMALL)
    params = init_nerf_params(net, generator=torch.Generator().manual_seed(2))
    lib = _FakeMlpLibrary()                         # pads the 32-wide net to 256
    monkeypatch.setattr(rm, "uses_kernel", lambda t: True)
    monkeypatch.setattr(rm, "_library", lambda name: lib)
    monkeypatch.setattr(rm, "_run", lambda fn, device, what, *args: fn(*args, None))
    m = 10
    widths = (net.input_ch, net.input_ch_views) if kind == "encoded" else (3, 3)
    a, b = torch.rand(m, widths[0]), torch.rand(m, widths[1])
    fn = getattr(rm, wrapper)
    fn.launches = 0
    with torch.no_grad():
        raw = fn(params, a, b, net, compute_dtype=dtype)
    assert raw.shape == (m, 4) and fn.launches == 1
    (args,) = lib.calls
    assert len(args) == len(rm._ARGTYPES["nerf_mlp"][1])
    assert args[3] == rm._KINDS[kind] and args[11] == int(dtype == torch.bfloat16)
    assert args[6] == 256                           # the core width
    packed = args[12]
    bf16 = dtype == torch.bfloat16
    assert packed is not None and packed % 16 == 0
    _, image, _ = rm._packed_weights(params, net, rm._depth(params), bf16, lib, wrapper)
    assert packed == image.data_ptr()
    padded = {k: round_to(v, dtype) if k.endswith("kernel") else v
              for k, v in rm.pad_params(params, net, 256).items()}
    want = rm.pack_wgmma_weights(padded, net) if bf16 else rm.pack_f32_weights(padded, net)
    torch.testing.assert_close(image, want, rtol=0, atol=0)
