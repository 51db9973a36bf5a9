"""Every ``inverse_hvp`` mode of the port (neuralsim_tpu_torch/hypergrad/
influence.py) against the JAX package's on the tiny detector loss of
tests/test_torch_influence.py (RetinaNet-R50-FPN at 32^2, 2 classes,
trainable FPN + head, weights carried by ``params_from_flax``), along v =
the detector Hessian's dominant direction: cg and cg_normal at 2
iterations, LiSSA at 2 with the auto scale. The JAX side is one compiled
program for all seven modes.

Tolerance: 1e-4 of the JAX result's norm (the difference's norm), except
cg and cg_normal: 1e-3. Their step sizes are ratios of dot products over
the ~12.8M trainable parameters, and XLA's float32 dot (``jnp.vdot``) is
off the float64 sum by ~3e-4 relative there (the port's ``tree_dot`` by
~1e-7, which the last test asserts): JAX's own solve carries that error.
Along a random v instead, v'Hv is ~2e-7 of |H| |v|^2 (the random-init
Hessian is indefinite) and both solves amplify rounding to ~1e-2.
"""

import jax
import numpy as np
import pytest

from neuralsim_tpu.hypergrad import influence as ji
from neuralsim_tpu_torch.hypergrad import influence as ti
from tests.test_torch_influence import MODES, TOL, detector, flat, rel

SOLVE_TOL = 1e-3      # cg and cg_normal (see the docstring)


@pytest.fixture(scope="module")
def jax_modes():
    """Every inverse_hvp mode of the JAX package on the detector loss, in one
    compiled program."""
    jloss, jtp, jb, *_, jv, _ = detector()

    def all_modes(t, v):
        return [ji.inverse_hvp(jloss, t, jb[0], v, m, cg_iters=2, lissa_iters=2,
                               lissa_scale=-1.0) for m in MODES]

    return dict(zip(MODES, jax.jit(all_modes)(jtp, jv)))


@pytest.mark.parametrize("mode", MODES)
def test_detector_inverse_hvp_modes(jax_modes, mode):
    _, _, _, tloss, ttp, tb, _, tv = detector()
    got = ti.inverse_hvp(tloss, ttp, tb[0], tv, mode, cg_iters=2, lissa_iters=2,
                         lissa_scale=-1.0)
    err = rel(flat(got), flat(jax_modes[mode]))
    print(f"detector inverse_hvp {mode}: {err:.2e} of the norm")
    assert np.isfinite(flat(got)).all()
    assert err < (SOLVE_TOL if mode in ("cg", "cg_normal") else TOL)


def test_detector_tree_dot_is_the_float64_sum():
    """The dot products the solvers divide by, over the detector's
    trainable parameters: the port's within 1e-6 of the float64 sum."""
    _, _, _, tloss, ttp, tb, _, tv = detector()
    hv = ti.hvp(tloss, ttp, tb[0], tv)
    for a, b in ((tv, tv), (tv, hv)):
        exact = flat(a).astype(np.float64) @ flat(b).astype(np.float64)
        assert abs(float(ti.tree_dot(a, b)) - exact) <= 1e-6 * abs(exact)
