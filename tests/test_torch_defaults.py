"""The port's kernel wrappers compute in the JAX package's default dtype:
each wrapper of ``neuralsim_tpu_torch.kernels.raymarch`` defaults to
bfloat16, as its counterpart in ``neuralsim_tpu/kernels/raymarch.py`` does,
so the same call with default arguments gives the same numbers on both
sides."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.config import NeRFNetConfig as JNet
from neuralsim_tpu.kernels import raymarch as jmarch
from neuralsim_tpu.models.nerf import init_nerf_params
from neuralsim_tpu.ops import encoding as jenc
from neuralsim_tpu_torch.config import NeRFNetConfig as TNet
from neuralsim_tpu_torch.kernels import raymarch as tmarch

torch.set_num_threads(2)

SMALL = dict(netdepth=4, netwidth=32, netdepth_fine=4, netwidth_fine=32, skips=(2,))
JNET, TNET = JNet(**SMALL), TNet(**SMALL)
WRAPPERS = ["fused_nerf_march", "fused_nerf_mlp_widepe", "fused_nerf_mlp_pe",
            "fused_nerf_mlp", "fused_render_tile"]
AS_JAX = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


@pytest.mark.parametrize("name", WRAPPERS)
def test_default_dtype_is_the_jax_wrappers(name):
    port = inspect.signature(getattr(tmarch, name)).parameters["compute_dtype"].default
    ref = inspect.signature(getattr(jmarch, name)).parameters["compute_dtype"].default
    assert jnp.dtype(AS_JAX[tmarch.as_dtype(port)]) == jnp.dtype(ref)


def test_fused_nerf_mlp_defaults_match_jax_defaults(rng):
    """Default arguments on both sides: the port's CPU path against the
    JAX Pallas kernel in interpret mode, at the bf16 tolerance of
    tests/test_torch_mlp_kernels.py; and the port's default is its bf16."""
    params = {k: np.array(v) for k, v in
              init_nerf_params(jax.random.PRNGKey(0), JNET).items()}
    pts = (0.15 * rng.randn(96, 3)).astype(np.float32)
    dirs = rng.randn(96, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    x_pe = np.array(jenc.positional_encoding(pts, 10))
    d_pe = np.array(jenc.positional_encoding(dirs, 4))
    want = jmarch._fused_forward(params, x_pe, d_pe, JNET, tile=128, interpret=True)

    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tx, td = torch.from_numpy(x_pe), torch.from_numpy(d_pe)
    got = tmarch.fused_nerf_mlp(tp, tx, td, TNET)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got, tmarch.fused_nerf_mlp(tp, tx, td, TNET, torch.bfloat16),
                               rtol=0, atol=0)
    assert not torch.equal(got, tmarch.fused_nerf_mlp(tp, tx, td, TNET, torch.float32))


def test_parallel_config_is_the_jax_one():
    """The mesh layout's defaults (every rank on the data axis, no model
    axis) and NeuralSimConfig's parallel section equal the JAX package's."""
    import dataclasses

    from neuralsim_tpu import config as jcfg
    from neuralsim_tpu_torch import config as tcfg

    assert dataclasses.asdict(tcfg.ParallelConfig()) == dataclasses.asdict(jcfg.ParallelConfig())
    assert dataclasses.asdict(tcfg.NeuralSimConfig().parallel) == dataclasses.asdict(
        jcfg.NeuralSimConfig().parallel) == {"data_axis": -1, "model_axis": 1}
    assert {f.name for f in dataclasses.fields(tcfg.NeuralSimConfig)} == {
        f.name for f in dataclasses.fields(jcfg.NeuralSimConfig)}
