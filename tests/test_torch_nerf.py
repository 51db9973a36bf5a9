"""Port parity: the NeRF MLP (``neuralsim_tpu_torch.models``) against
``neuralsim_tpu.models.nerf``, in float32 and bfloat16, plus the weight
conversions of ``models/convert.py`` and the box-density scene.

Weights come from the JAX package's init (or its ``bench.box_scene_params``)
and reach the port as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import box_scene_params as jax_box_scene
from neuralsim_tpu.config import NeRFNetConfig as JNet
from neuralsim_tpu.data import convert_torch as jconvert
from neuralsim_tpu.models import nerf as jnerf
from neuralsim_tpu_torch.config import NeRFNetConfig as TNet
from neuralsim_tpu_torch.models import convert as tconvert
from neuralsim_tpu_torch.models import nerf as tnerf
from neuralsim_tpu_torch.models.box_scene import box_scene_params

torch.set_num_threads(2)

SMALL = dict(netdepth=4, netwidth=32, netdepth_fine=4, netwidth_fine=32, skips=(2,))
JNET, TNET = JNet(**SMALL), TNet(**SMALL)

# float32 on both sides through a 7-matmul chain of width 32
TOL = dict(rtol=1e-4, atol=1e-4)


def bf16_close(got, want):
    """tests_tpu/test_kernels_tpu.py:79-86: bf16 rounding noise around a
    ReLU knee may move a tiny fraction of elements."""
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)
    bad = err > 0.5 + 0.05 * np.abs(want)
    assert bad.mean() <= 1e-3, f"{bad.mean():.2%} outside bf16 tolerance"
    assert err.max() < 4.0, f"gross bf16 divergence: {err.max():.3f}"


def _params(seed=0):
    p = jnerf.init_nerf_params(jax.random.PRNGKey(seed), JNET)
    return {k: np.array(v) for k, v in p.items()}


def _torch(params):
    return {k: torch.from_numpy(v) for k, v in params.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nerf_apply_matches_jax(rng, dtype):
    params = _params()
    x = rng.randn(300, JNET.input_ch).astype(np.float32)
    d = rng.randn(300, JNET.input_ch_views).astype(np.float32)
    want = jnerf.nerf_apply(params, x, d, JNET, compute_dtype=jnp.dtype(dtype))
    got = tnerf.nerf_apply(_torch(params), torch.from_numpy(x), torch.from_numpy(d),
                           TNET, compute_dtype=getattr(torch, dtype))
    assert got.shape == (300, 4) and got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        # both sides round at the same places, so they agree far inside the
        # bf16 rule; the rule is what the kernel is held to
        bf16_close(got.numpy(), want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_query_points_matches_jax(rng, dtype):
    params = _params(1)
    pts = (rng.randn(12, 9, 3) * 0.5).astype(np.float32)
    vd = rng.randn(12, 3).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    want = jnerf.query_points(params, pts, vd, JNET, jnp.dtype(dtype))
    got = tnerf.query_points(_torch(params), torch.from_numpy(pts),
                             torch.from_numpy(vd), TNET, getattr(torch, dtype))
    assert got.shape == (12, 9, 4)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        bf16_close(got.numpy(), want)


def test_make_sigma_fn_matches_jax(rng):
    params = {k: np.array(v) for k, v in
              jax_box_scene(JNET, jax.random.PRNGKey(0)).items()}
    pts = (rng.rand(400, 3) * 0.2 - 0.1).astype(np.float32)
    want = jnerf.make_sigma_fn(params, JNET)(pts)
    got = tnerf.make_sigma_fn(_torch(params), TNET)(torch.from_numpy(pts))
    assert (np.asarray(want) > 0).any()              # the box is in range
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_shapes_match_jax():
    want = jnerf.init_nerf_pipeline_params(jax.random.PRNGKey(0), JNET, 16)
    got = tnerf.init_nerf_pipeline_params(TNET, 16, torch.Generator().manual_seed(0))
    assert set(got) == set(want)
    for name in want:
        assert {k: tuple(v.shape) for k, v in got[name].items()} == \
               {k: tuple(v.shape) for k, v in want[name].items()}
        bound = 1.0 / np.sqrt(got[name]["pts_0_kernel"].shape[0])
        assert float(got[name]["pts_0_kernel"].abs().max()) <= bound


def test_nerf_module_is_query_points(rng):
    params = _torch(_params())
    module = tnerf.NeRF(params, TNET)
    pts = torch.from_numpy(rng.randn(4, 5, 3).astype(np.float32))
    vd = torch.nn.functional.normalize(torch.from_numpy(rng.randn(4, 3).astype(np.float32)), dim=-1)
    torch.testing.assert_close(module(pts, vd),
                               tnerf.query_points(params, pts, vd, TNET), rtol=0, atol=0)
    assert len(list(module.parameters())) == len(params)


@pytest.mark.parametrize("view_gate", [0.0, 1.5])
def test_box_scene_matches_bench(view_gate):
    want = {k: np.asarray(v) for k, v in
            jax_box_scene(JNET, jax.random.PRNGKey(0), view_gate=view_gate).items()}
    got = tconvert.params_to_numpy(
        {"m": box_scene_params(TNET, torch.Generator().manual_seed(0),
                               view_gate=view_gate)})["m"]
    assert set(got) == set(want)
    # the hand-built parts are exact; only the x0.01 random rgb head of the
    # ungated scene comes from each side's own generator
    random_keys = set() if view_gate else {k for k in want if k.startswith(
        ("feature", "views", "rgb"))}
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k in random_keys:
            assert np.abs(got[k]).max() <= 0.01
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_numpy_round_trip():
    models = {"coarse": _params(0), "fine": _params(1)}
    tensors = tconvert.params_from_numpy(models, "cpu")
    assert tensors["fine"]["rgb_kernel"].dtype == torch.float32
    back = tconvert.params_to_numpy(tensors)
    for name in models:
        for k in models[name]:
            np.testing.assert_array_equal(back[name][k], models[name][k])


def test_checkpoint_conversion_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    sd = {}
    for i in range(4):
        fan_in = 63 if i == 0 else (32 + 63 if i == 3 else 32)
        sd[f"pts_linears.{i}.weight"] = torch.from_numpy(rng.randn(32, fan_in).astype(np.float32))
        sd[f"pts_linears.{i}.bias"] = torch.from_numpy(rng.randn(32).astype(np.float32))
    for name, (o, i) in {"feature_linear": (32, 32), "alpha_linear": (1, 32),
                         "views_linears.0": (16, 59), "rgb_linear": (3, 16)}.items():
        sd[f"{name}.weight"] = torch.from_numpy(rng.randn(o, i).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(rng.randn(o).astype(np.float32))
    ckpt = {"global_step": 7, "network_fn_state_dict": sd, "network_fine_state_dict": sd}
    want = jconvert.convert_torch_checkpoint(ckpt)
    path = tmp_path / "ycbvid2.tar"
    torch.save(ckpt, path)
    got, step = tconvert.load_nerf_checkpoint(str(path))
    assert step == 7 and set(got) == {"coarse", "fine"}
    for name in want:
        for k in want[name]:
            np.testing.assert_array_equal(got[name][k], want[name][k])
    tconvert.save_params_npz(str(tmp_path / "m.npz"), got)
    again = jconvert.load_params_npz(str(tmp_path / "m.npz"))
    for k in got["coarse"]:
        np.testing.assert_array_equal(again["coarse"][k], got["coarse"][k])
