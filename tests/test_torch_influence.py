"""The port's influence engine (neuralsim_tpu_torch/hypergrad/influence.py)
against the JAX package's, on the same numpy inputs.

On quadratic losses, as tests/test_influence.py: every function against
JAX and the closed forms (CG solves (A + damping I) x = v, LiSSA converges
to (A + damping I)^-1 v, cg_normal on an indefinite A, LiSSA's auto scale
where a fixed scale diverges, the stacked-batch shape guard, the
implicit-function-theorem sign). On the tiny detector loss (RetinaNet-
R50-FPN at 32^2, 2 classes, trainable FPN + head, weights carried by
``params_from_flax``): grad_loss over a list and a stack of batches, hvp,
and mixed_grad_wrt_images, along v = the detector Hessian's dominant
direction (6 power iterations); every inverse_hvp mode on it is in
tests/test_torch_influence_modes.py. Tolerance: 1e-4 of the JAX result's
norm (the difference's norm).

The driver's grad_E in batches (``BilevelDriver._grad_e``: one
``mixed_grad_wrt_image_batch`` a batch under the per-image normalizer)
against the port's serial mixed_grad_wrt_images at batch 1, image by
image, to 1e-5 of the serial grad_E's norm.
"""

import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.detector import trainer as jt
from neuralsim_tpu.hypergrad import influence as ji
from neuralsim_tpu.models import retinanet as jr
from neuralsim_tpu_torch.bilevel.driver import BilevelDriver
from neuralsim_tpu_torch.config import DetectorConfig
from neuralsim_tpu_torch.detector import trainer as tt
from neuralsim_tpu_torch.detector.dataset import prepare_images
from neuralsim_tpu_torch.hypergrad import influence as ti
from neuralsim_tpu_torch.models import retinanet as tr
from neuralsim_tpu_torch.models.convert_retinanet import params_from_flax, params_to_flax
from neuralsim_tpu_torch.ops.boxes import match_anchors
from tests.test_torch_retinanet import carried_params, jdc_of, loss_batch

torch.set_num_threads(2)

TOL = 1e-4
MODES = ("identity", "ones", "onestep", "neumann", "cg", "cg_normal", "lissa")


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# --------------------------------------------------------------------------- #
# quadratic losses
# --------------------------------------------------------------------------- #


def jquad(params, batch):
    A, b = batch
    th = params["theta"]
    return 0.5 * th @ A @ th + b @ th


def tquad(params, batch):
    A, b = batch
    th = params["theta"]
    return 0.5 * th @ A @ th + b @ th


def quad_setup(seed=0, d=6, eigs=None):
    rng = np.random.RandomState(seed)
    if eigs is None:
        M = rng.randn(d, d)
        A = (M @ M.T + d * np.eye(d)).astype(np.float32)
    else:
        Q, _ = np.linalg.qr(rng.randn(d, d))
        A = (Q @ np.diag(eigs) @ Q.T).astype(np.float32)
    b = rng.randn(d).astype(np.float32)
    theta = rng.randn(d).astype(np.float32)
    v = rng.randn(d).astype(np.float32)
    return A, b, theta, v


def both(A, b, theta, v):
    """(JAX args, port args): params, batch, v."""
    j = ({"theta": jnp.asarray(theta)}, (jnp.asarray(A), jnp.asarray(b)),
         {"theta": jnp.asarray(v)})
    t = ({"theta": torch.from_numpy(theta)}, (torch.from_numpy(A), torch.from_numpy(b)),
         {"theta": torch.from_numpy(v)})
    return j, t


def test_grad_loss_list_and_stack():
    A, b, theta, v = quad_setup()
    (jp, jb, _), (tp, tb, _) = both(A, b, theta, v)
    want = np.asarray(ji.grad_loss(jquad, jp, [jb, jb])["theta"])
    got = ti.grad_loss(tquad, tp, [tb, tb])["theta"].numpy()
    np.testing.assert_allclose(got, 2 * (A @ theta + b), rtol=1e-4)
    assert rel(got, want) < TOL
    stacked = (torch.stack([tb[0]] * 3), torch.stack([tb[1]] * 3))
    got3 = ti.grad_loss(tquad, tp, stacked)["theta"].numpy()
    want3 = np.asarray(ji.grad_loss(jquad, jp, (jnp.stack([jb[0]] * 3),
                                                jnp.stack([jb[1]] * 3)))["theta"])
    assert rel(got3, want3) < TOL


def test_hvp_and_hvp_mean():
    A, b, theta, v = quad_setup()
    (jp, jb, jv), (tp, tb, tv) = both(A, b, theta, v)
    got = ti.hvp(tquad, tp, tb, tv)["theta"].numpy()
    np.testing.assert_allclose(got, A @ v, rtol=1e-4)
    assert rel(got, ji.hvp(jquad, jp, jb, jv)["theta"]) < TOL
    d = 6
    As = np.stack([2 * np.eye(d), 4 * np.eye(d)]).astype(np.float32)
    bs = np.zeros((2, d), np.float32)
    got = ti.hvp_mean(tquad, tp, (torch.from_numpy(As), torch.from_numpy(bs)), tv)["theta"]
    want = ji.hvp_mean(jquad, jp, (jnp.asarray(As), jnp.asarray(bs)), jv)["theta"]
    np.testing.assert_allclose(got.numpy(), 3 * v, rtol=1e-5)
    assert rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("mode", MODES)
def test_inverse_hvp_modes_on_a_quadratic(mode):
    A, b, theta, v = quad_setup()
    (jp, jb, jv), (tp, tb, tv) = both(A, b, theta, v)
    kw = dict(damping=1e-2, cg_iters=30, lissa_iters=400,
              lissa_scale=float(np.linalg.norm(A + 1e-2 * np.eye(6), 2)) * 1.5)
    got = ti.inverse_hvp(tquad, tp, tb, tv, mode, **kw)["theta"].numpy()
    want = np.asarray(ji.inverse_hvp(jquad, jp, jb, jv, mode, **kw)["theta"])
    assert rel(got, want) < TOL
    closed = {"identity": v, "ones": np.ones_like(v), "onestep": A @ v + 1e-2 * v,
              "neumann": 2 * v - A @ v,
              "cg": np.linalg.solve(A + 1e-2 * np.eye(6), v),
              "lissa": np.linalg.solve(A + 1e-2 * np.eye(6), v)}
    if mode in closed:
        np.testing.assert_allclose(got, closed[mode], rtol=1e-3, atol=1e-4)


def test_cg_normal_on_an_indefinite_hessian():
    A, b, _, v = quad_setup(eigs=np.array([4.0, 2.5, 1.5, -0.8, -2.0, -3.5]))
    (jp, jb, jv), (tp, tb, tv) = both(A, np.zeros(6, np.float32), np.zeros(6, np.float32), v)
    got = ti.inverse_hvp(tquad, tp, tb, tv, "cg_normal", damping=1e-2, cg_iters=50)["theta"]
    want = ji.inverse_hvp(jquad, jp, jb, jv, "cg_normal", damping=1e-2, cg_iters=50)["theta"]
    A_d = A + 1e-2 * np.eye(6, dtype=np.float32)
    closed = np.linalg.solve(A_d @ A_d + 1e-4 * np.eye(6), A_d @ v)
    np.testing.assert_allclose(got.numpy(), closed, rtol=1e-3, atol=1e-4)
    assert rel(got.numpy(), want) < TOL


def test_lissa_auto_scale_guards_divergence():
    rng = np.random.RandomState(0)
    M = rng.randn(6, 6)
    A = (M @ M.T + 50.0 * np.eye(6)).astype(np.float32)      # ||A|| >> 25
    v = rng.randn(6).astype(np.float32)
    (jp, jb, jv), (tp, tb, tv) = both(A, np.zeros(6, np.float32), np.zeros(6, np.float32), v)
    want_x = np.linalg.solve(A + 1e-2 * np.eye(6), v)
    fixed = ti.inverse_hvp(tquad, tp, tb, tv, "lissa", lissa_iters=80,
                           lissa_scale=25.0)["theta"].numpy()
    assert not np.isfinite(fixed).all() or rel(fixed, want_x) > 10.0
    got = ti.inverse_hvp(tquad, tp, tb, tv, "lissa", lissa_iters=2000,
                         lissa_scale=-1.0)["theta"].numpy()
    want = ji.inverse_hvp(jquad, jp, jb, jv, "lissa", lissa_iters=2000,
                          lissa_scale=-1.0)["theta"]
    np.testing.assert_allclose(got, want_x, rtol=2e-2, atol=1e-4)
    assert rel(got, want) < TOL


def test_lissa_stacked_batches_and_shape_guard():
    A, b, theta, v = quad_setup()
    (jp, jb, jv), (tp, tb, tv) = both(A, b, theta, v)
    iters, scale = 200, float(np.linalg.norm(A + 1e-2 * np.eye(6), 2)) * 2.0
    factors = np.where(np.arange(iters) % 2 == 0, 1.05, 0.95)
    As = (factors[:, None, None] * A[None]).astype(np.float32)
    bs = np.broadcast_to(b, (iters, 6)).copy()
    got = ti.inverse_hvp(tquad, tp, (torch.from_numpy(As), torch.from_numpy(bs)), tv, "lissa",
                         lissa_iters=iters, lissa_scale=scale, lissa_stacked=True)["theta"]
    want = ji.inverse_hvp(jquad, jp, (jnp.asarray(As), jnp.asarray(bs)), jv, "lissa",
                          lissa_iters=iters, lissa_scale=scale, lissa_stacked=True)["theta"]
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(A + 1e-2 * np.eye(6), v),
                               rtol=2e-2, atol=1e-3)
    assert rel(got.numpy(), want) < TOL
    with pytest.raises(ValueError, match=r"lead with \[7\]"):
        ti.inverse_hvp(tquad, tp, tb, tv, "lissa", lissa_iters=7, lissa_stacked=True)
    with pytest.raises(ValueError, match="unknown inverse-HVP method"):
        ti.inverse_hvp(tquad, tp, tb, tv, "newton")


def test_mixed_grad_closed_form_and_ift_sign():
    rng = np.random.RandomState(1)
    W = rng.randn(4, 9).astype(np.float32)
    v = rng.randn(4).astype(np.float32)
    theta = rng.randn(4).astype(np.float32)
    images = rng.randn(2, 3, 3).astype(np.float32)
    got = ti.mixed_grad_wrt_images(
        lambda p, img: p["theta"] @ (torch.from_numpy(W) @ img.reshape(-1)),
        {"theta": torch.from_numpy(theta)}, torch.from_numpy(images),
        {"theta": torch.from_numpy(v)})
    want = ji.mixed_grad_wrt_images(
        lambda p, img: p["theta"] @ (jnp.asarray(W) @ img.reshape(-1)),
        {"theta": jnp.asarray(theta)}, jnp.asarray(images), {"theta": jnp.asarray(v)})
    np.testing.assert_allclose(got.numpy(), np.broadcast_to((W.T @ v).reshape(3, 3), (2, 3, 3)),
                               rtol=1e-4, atol=1e-5)
    assert rel(got.numpy(), want) < TOL
    # the implicit-function-theorem sign: -mixed.(H^-1 v) is the true
    # dL_val/dI of a quadratic inner problem (theta*(I) = A I, H = Id)
    A = torch.from_numpy(rng.randn(4, 3).astype(np.float32))
    t = torch.from_numpy(rng.randn(4).astype(np.float32))
    img = torch.from_numpy(rng.randn(3).astype(np.float32))
    theta_star = A @ img
    loss_tr = lambda p, i: 0.5 * torch.sum((p - A @ i) ** 2)            # noqa: E731
    vv = theta_star - t                                                # dL_val/dtheta
    ihvp = ti.inverse_hvp(loss_tr, theta_star, img, vv, method="cg", damping=0.0,
                          cg_iters=8)
    ge = ti.mixed_grad_wrt_images(loss_tr, theta_star, img[None], ihvp)[0]
    np.testing.assert_allclose((-ge).numpy(), (A.T @ (theta_star - t)).numpy(), rtol=1e-4,
                               atol=1e-6)


def test_tree_dot_and_axpy():
    a = {"x": torch.tensor([1.0, 2.0]), "y": [torch.tensor([[3.0]])]}
    b = {"x": torch.tensor([4.0, 5.0]), "y": [torch.tensor([[2.0]])]}
    assert float(ti.tree_dot(a, b)) == float(ti.flat_dot(a, b)) == 1 * 4 + 2 * 5 + 3 * 2
    out = ti.tree_axpy(2.0, a, b)
    assert out["x"].tolist() == [6.0, 9.0] and out["y"][0].tolist() == [[8.0]]


# --------------------------------------------------------------------------- #
# the tiny detector loss
# --------------------------------------------------------------------------- #

DC = DetectorConfig(num_classes=2, image_size=32, images_per_batch=2)


@functools.lru_cache(maxsize=1)
def detector():
    """(JAX loss, JAX trainable, JAX batches, port loss, port trainable,
    port batches, v as both trees)."""
    jdc = jdc_of(DC)
    port, flax = carried_params(DC)
    raw = [loss_batch(np.random.RandomState(s), n=2, size=32, num_classes=2) for s in (0, 1)]
    jb = [jr.DetBatch(*map(jnp.asarray, b)) for b in raw]
    tb = [tr.DetBatch(*(torch.from_numpy(np.array(x)) for x in b)) for b in raw]
    jtp, jfr = jt.split_trainable(flax, jdc)
    ttp, tfr = tt.split_trainable(port, DC)
    _, japply = jt.make_detector_apply(jdc)
    _, tapply = tt.make_detector_apply(DC)
    janchors = jnp.concatenate(jr.generate_anchors(32), 0)
    tanchors = torch.cat(tr.generate_anchors(32), 0)

    def jloss(t, b):
        return jr.retinanet_loss(japply, jt.merge_params(t, jfr), b, janchors, jdc)[0]

    def tloss(t, b):
        return tr.retinanet_loss(tapply, tt.merge_params(t, tfr), b, tanchors, DC)[0]

    # v along the Hessian's dominant direction, |v| = 1e-2
    rs = np.random.RandomState(2)
    tv = {k: torch.from_numpy(rs.randn(*x.shape).astype(np.float32)) for k, x in ttp.items()}
    for _ in range(6):
        hv = ti.hvp(tloss, ttp, tb[0], tv)
        norm = torch.sqrt(ti.tree_dot(hv, hv))
        tv = {k: 1e-2 * x / norm for k, x in hv.items()}
    jv = jax.tree_util.tree_map(jnp.asarray, params_to_flax(tv))
    return jloss, jtp, jb, tloss, ttp, tb, jv, tv


def flat(tree) -> np.ndarray:
    if not all(isinstance(x, torch.Tensor) for x in tree.values()):
        tree = params_from_flax(jax.tree_util.tree_map(np.asarray, tree))
    return np.concatenate([tree[k].detach().numpy().reshape(-1) for k in sorted(tree)])


def test_detector_grad_loss_and_hvp():
    jloss, jtp, jb, tloss, ttp, tb, jv, tv = detector()
    g = ti.grad_loss(tloss, ttp, tb)
    jg = jax.jit(lambda t: ji.grad_loss(jloss, t, jb))(jtp)
    assert rel(flat(g), flat(jg)) < TOL
    stacked = tr.DetBatch(*(torch.stack(x) for x in zip(*tb)))
    assert rel(flat(ti.grad_loss(tloss, ttp, stacked)), flat(g)) < 1e-6
    hv = ti.hvp(tloss, ttp, tb[0], tv)
    jhv = jax.jit(lambda t, v: ji.hvp(jloss, t, jb[0], v))(jtp, jv)
    err = rel(flat(hv), flat(jhv))
    print(f"detector hvp: {err:.2e} of the norm")
    assert np.linalg.norm(flat(jhv)) > 0 and err < TOL


def test_detector_mixed_grad_wrt_images():
    """grad_E of 2 images, each its own batch of 1 (boxes of that image)."""
    jloss, jtp, jb, tloss, ttp, tb, jv, tv = detector()
    images = tb[0].images

    def tloss_img(i):
        return lambda t, img: tloss(t, tr.DetBatch(img[None], *(x[i:i + 1] for x in tb[0][1:])))

    def jloss_img(i):
        return lambda t, img: jloss(t, jr.DetBatch(img[None], *(x[i:i + 1] for x in jb[0][1:])))

    got = torch.cat([ti.mixed_grad_wrt_images(tloss_img(i), ttp, images[i:i + 1], tv)
                     for i in range(2)])
    want = np.concatenate([np.asarray(jax.jit(
        lambda t, im, v, i=i: ji.mixed_grad_wrt_images(jloss_img(i), t, im, v))(
            jtp, jb[0].images[i:i + 1], jv)) for i in range(2)])
    err = rel(got.numpy(), want)
    print(f"detector mixed_grad_wrt_images: {err:.2e} of the norm")
    assert np.abs(want).max() > 0 and err < TOL


# --------------------------------------------------------------------------- #
# grad_E in batches
# --------------------------------------------------------------------------- #


def grad_e_stage(shared_norm: bool = False):
    """``BilevelDriver._grad_e`` on a stand-in holding what it reads: the
    tiny detector at images_per_batch 2. ``shared_norm`` plants the fault
    of batching under the batch's shared normalizer."""
    drv = types.SimpleNamespace(cfg=types.SimpleNamespace(detector=DC),
                                det_apply=tt.make_detector_apply(DC)[1],
                                anchors_cat=torch.cat(tr.generate_anchors(32), 0))

    def det_loss(tp, frozen, batch, image_weight=None, per_image_norm=False):
        return BilevelDriver._det_loss_trainable(drv, tp, frozen, batch, image_weight,
                                                 per_image_norm and not shared_norm)

    drv._det_loss_trainable = det_loss
    return functools.partial(BilevelDriver._grad_e, drv)


def serial_grad_e(params, renders, boxes, labels, valid, v):
    """grad_E one image at a time, each its own batch of 1 under the
    default normalizer."""
    trainable, frozen = tt.split_trainable(params, DC)
    apply = tt.make_detector_apply(DC)[1]
    anchors = torch.cat(tr.generate_anchors(32), 0)

    def loss_img(i):
        def loss(t, r):
            batch = tr.DetBatch(prepare_images(r[None], DC), boxes[i:i + 1], labels[i:i + 1],
                                valid[i:i + 1])
            return tr.retinanet_loss(apply, tt.merge_params(t, frozen), batch, anchors, DC)[0]
        return loss

    return torch.cat([ti.mixed_grad_wrt_images(loss_img(i), trainable, renders[i:i + 1], v)
                      for i in range(renders.shape[0])])


@functools.lru_cache(maxsize=1)
def five_images():
    """(full params, 5 images with their boxes, v, serial grad_E): one image
    with no foreground anchor (its normalizer clamps at 1) and images with
    different foreground counts (a shared normalizer rescales them)."""
    *_, tv = detector()
    params, _ = carried_params(DC)
    raw = loss_batch(np.random.RandomState(3), n=5, size=32, num_classes=2)
    data = tuple(torch.from_numpy(np.array(x)) for x in raw)
    _, mlabel = match_anchors(torch.cat(tr.generate_anchors(32), 0), data[1], data[3],
                              DC.iou_fg_threshold, DC.iou_bg_threshold)
    n_fg = (mlabel == 1).sum(-1).tolist()
    assert 0 in n_fg and len({n for n in n_fg if n > 0}) >= 2, n_fg
    return params, data, tv, serial_grad_e(params, *data, tv)


def row_errors(got, want) -> list:
    """Each image's difference over the norm of the serial grad_E (the
    image without foreground has a row ~2,000x smaller than the others,
    whose rounding its own norm would judge)."""
    return [float(torch.linalg.norm(g - w) / torch.linalg.norm(want)) for g, w in zip(got, want)]


def test_batched_grad_e_equals_serial_image_by_image():
    """P = 5 at batch 2: batches of 2, 2 and a tail of 1 padded with a
    zero-weight image; the counters read ceil(P / B) batches and P images."""
    params, data, tv, want = five_images()
    fn = ti.mixed_grad_wrt_image_batch
    batches, images = fn.batches, fn.images
    got = grad_e_stage()(params, *data, tv)
    assert (fn.batches - batches, fn.images - images) == (math.ceil(5 / DC.images_per_batch), 5)
    assert got.shape == want.shape == (5, 32, 32, 3)
    assert all(float(torch.linalg.norm(w)) > 0 for w in want)
    errs = row_errors(got, want)
    print(f"batched grad_E against serial, per image: {errs}")
    assert max(errs) < 1e-5


def test_batched_grad_e_under_a_shared_normalizer_fails_the_comparison():
    params, data, tv, want = five_images()
    errs = row_errors(grad_e_stage(shared_norm=True)(params, *data, tv), want)
    assert max(errs) > 1e-2, errs
