"""Nets past the shapes the kernels refused before: trunks deeper than 64
layers and encodings past multires 128.

- The kernels take any depth: a net's bias pointers and skip-mask words
  reach them through a device table (``raymarch.net_table``). The port's
  twins are held to the JAX package's Pallas kernels in interpret mode on a
  70-deep narrow net whose skips (4, 40, 66) lie in both 64-bit words of
  the mask.
- Past multires 128, 2^k is +inf in float32 in both packages: the
  encodings' k >= 128 rows are NaN, and the MLP carries the NaN into every
  output (ReLU keeps a NaN in both). The twins are held to the JAX kernels
  at multires 130 on their NaN masks, what the JAX package does at 129 is
  checked where it happens, and the kernels take such a net on their route.

The CUDA kernels themselves run only on the card, where chip_smoke.py holds
them against their twins on a 72-deep net and a multires-130 net.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.config import NeRFNetConfig as JNet
from neuralsim_tpu.kernels import raymarch as jmarch
from neuralsim_tpu.ops import encoding as jenc
from neuralsim_tpu_torch.config import NeRFNetConfig as TNet
from neuralsim_tpu_torch.kernels import raymarch as rm
from neuralsim_tpu_torch.models.nerf import init_nerf_params, nerf_apply
from neuralsim_tpu_torch.ops.encoding import positional_encoding
from tests.test_torch_net_shapes import fake_march  # noqa: F401  (a fixture)
from tests.test_torch_wide_nets import _jax_params, _points, _rays, _t

torch.set_num_threads(2)

# float32 on both sides: PE + a 73-matmul chain of width 32
TOL = dict(rtol=1e-4, atol=1e-4)
DEEP = dict(netdepth=70, netwidth=32, netdepth_fine=70, netwidth_fine=32, skips=(4, 40, 66))
LONG_PE = dict(netdepth=4, netwidth=32, netdepth_fine=4, netwidth_fine=32, skips=(2,),
               multires=130, multires_views=4)


def _both(kw, kernel, rng):
    """(JAX kernel in interpret mode, the port's twin) on one net and the
    same numpy inputs, as tuples of numpy arrays."""
    jnet, tnet = JNet(**kw), TNet(**kw)
    params = _jax_params(kw, 5)
    if kernel == "march":
        o, d, vd, z = _rays(rng, 12, 16, far=2.0)
        want = jmarch._fused_march_channels(params, o, d, vd, z, jnet,
                                            compute_dtype=jnp.float32, target_tile=128,
                                            interpret=True)
        got = rm.march_channels_ref(*_t(params, o, d, vd, z), tnet)
    else:
        pts, dirs = _points(rng, 150)
        if kernel == "widepe":
            want = (jmarch._fused_forward_widepe(params, pts, dirs, jnet,
                                                 compute_dtype=jnp.float32, tile=128,
                                                 interpret=True),)
            got = (rm.mlp_widepe_ref(*_t(params, pts, dirs), tnet),)
        elif kernel == "pe":
            want = (jmarch._fused_forward_pe(params, pts, dirs, jnet,
                                             compute_dtype=jnp.float32, tile=64,
                                             interpret=True),)
            got = (rm.mlp_pe_ref(*_t(params, pts, dirs), tnet),)
        else:
            x_pe = np.asarray(jenc.positional_encoding(pts, jnet.multires))
            d_pe = np.asarray(jenc.positional_encoding(dirs, jnet.multires_views))
            want = (jmarch._fused_forward(params, x_pe, d_pe, jnet, compute_dtype=jnp.float32,
                                          tile=128, interpret=True),)
            got = (nerf_apply(*_t(params, x_pe, d_pe), tnet),)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("kernel", ["march", "widepe", "encoded"])
def test_twins_match_pallas_interpret_at_depth_70(rng, kernel):
    """Kernels 1, 2 and 4 on a 70-deep, 32-wide net with skips after layers
    4, 40 and 66 (random weights, float32): the port's twin against the JAX
    kernel in interpret mode."""
    want, got = _both(DEEP, kernel, rng)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(w).all() and np.abs(w).max() > 1e-3
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("kernel", ["march", "widepe", "pe", "encoded"])
def test_twins_match_pallas_interpret_past_multires_128(rng, kernel):
    """Kernels 1, 2, 5 and 4 on a net with multires 130: the JAX kernels
    (in interpret mode) and the port's twins are NaN at the same outputs,
    every one of them (the k >= 128 rows of the encoding are NaN and the MLP
    carries the NaN through every ReLU)."""
    want, got = _both(LONG_PE, kernel, rng)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        assert np.isnan(w).all()


def test_encodings_past_multires_128_are_nan_rows(rng):
    """What the JAX package does at multires 129, and the port alike: the
    projection form's frequency constants overflow numpy's float32 cast to
    +inf (a RuntimeWarning, expected here) in the k = 128 columns only; both
    forms of the encoding, in both packages, are NaN exactly in the k = 128
    rows (3 + 6 * 128 onward) and finite before them."""
    with pytest.warns(RuntimeWarning, match="overflow"):
        freq, _ = jenc._pe_projection.__wrapped__(3, 129)
    top = np.zeros(freq.shape[1], bool)
    top[6 * 128:] = True
    assert np.isinf(freq[:, top]).sum() == 6 and np.isfinite(freq[:, ~top]).all()
    pts, _ = _points(rng, 40)
    rows = np.zeros(3 + 6 * 129, bool)
    rows[3 + 6 * 128:] = True
    for projection in (False, True):
        enc = [np.asarray(jenc.positional_encoding(pts, 129, projection=projection)),
               positional_encoding(torch.from_numpy(pts), 129, projection=projection).numpy()]
        for e in enc:
            assert e.shape == (40, rows.size)
            assert np.isnan(e[:, rows]).all() and np.isfinite(e[:, ~rows]).all()
        np.testing.assert_allclose(enc[1][:, ~rows], enc[0][:, ~rows], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kw", [dict(netdepth=72, netdepth_fine=72, skips=(4, 40, 68)),
                                dict(LONG_PE, netwidth=512, netwidth_fine=512)],
                         ids=["72x256", "4x512_pe130_4"])
def test_kernels_take_deep_nets_and_long_encodings(fake_march, kw, dtype):
    """On the kernel route a 72-deep net and a 512-wide one at multires 130
    (both refused before) reach the C entry in both dtypes, with their depth
    and channel counts; the 72-deep net's table holds its 76 biases and two
    skip words."""
    net = TNet(**kw)
    params = init_nerf_params(net, generator=torch.Generator().manual_seed(9))
    rays = [torch.rand(3, 3), torch.rand(3, 3), torch.rand(3, 3), torch.rand(3, 4)]
    with torch.no_grad():
        rm.fused_nerf_march(params, *rays, net, compute_dtype=dtype)
    (args,) = fake_march.calls
    assert args[9:13] == (net.netdepth, len(net.skips), net.input_ch, net.input_ch_views)
    table = rm._packed_weights(params, net, net.netdepth, dtype == torch.bfloat16, fake_march,
                               "test")[2]
    assert args[7] == table.data_ptr()
    assert table.numel() == net.netdepth + 4 + -(-net.netdepth // 64)
