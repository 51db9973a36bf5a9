"""The port's bilevel driver (neuralsim_tpu_torch/bilevel/driver.py)
against the JAX package's, on one epoch from one state.

Both drivers start from the same state: the JAX driver's checkpoint layout
(``_ckpt_state``, with a nonzero momentum trace and psi momentum) carried
into the port by ``bilevel_state_from_jax``. The port's epoch takes the
JAX driver's draws, rebuilt from its key exactly as ``run_epoch`` splits it
(pose noise, inner-train schedule, HVP batch). The scene is the box scene
on a 4x32 net at 24x24; the detector RetinaNet-R50-FPN at 32^2 with 2
classes, 2 inner steps at batch 2, and 3 val images (a padded tail). The
Gumbel temperature is 1.0, so the psi gradient is not saturated (the test
asserts its size).

Stage by stage, each port stage runs on the inputs the JAX stage got
(captured from the JAX epoch): v = dL_val/dtheta with the padded tail,
the inverse HVP, grad_E, evaluate with a tail. Tolerances: renders 1e-4;
inner losses 1e-4 relative; v, the inverse HVP and grad_E 1e-4 of the JAX
norm (the difference's norm); grad_psi 1e-3 of the norm; psi after the
step 1e-5; the save_result.txt lines equal.
"""

import dataclasses
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import box_scene_params as jax_box_scene
from neuralsim_tpu import config as jcfg
from neuralsim_tpu.bilevel import driver as jdriver
from neuralsim_tpu.bilevel.psi_opt import psi_optimizer_init as jpsi_opt_init
from neuralsim_tpu.detector import dataset as jds
from neuralsim_tpu.detector import trainer as jt
from neuralsim_tpu.sampler import poses as jposes
from neuralsim_tpu_torch import config as tcfg
from neuralsim_tpu_torch.bilevel import driver as tdriver
from neuralsim_tpu_torch.models.convert_retinanet import params_from_flax
from neuralsim_tpu_torch.models.retinanet import DetBatch
from neuralsim_tpu_torch.sampler.poses import GaussianPoseNoise, PoseNoise
from tests.test_torch_detector_io import same_result
from tests.test_torch_retinanet import carried_params

torch.set_num_threads(2)

SMALL = dict(netdepth=4, netwidth=32, netdepth_fine=4, netwidth_fine=32, skips=(2,))
CAMERA = dict(height=24, width=24, focal=60.0, fx=60.0, fy=60.0, cx=12.0, cy=12.0)
TOL = 1e-4
PSI_TOL = 1e-5
GRAD_PSI_TOL = 1e-3
# random-init class logits sit at the 0.01 prior, below the 0.05 score
# threshold: the evaluate test scales their kernel so detections exist
CLS_KERNEL_SCALE = 12.0


def port_cfg(render=None, **bilevel) -> tcfg.NeuralSimConfig:
    """The test configuration (see the module docstring)."""
    return tcfg.NeuralSimConfig(
        net=tcfg.NeRFNetConfig(**SMALL),
        render=tcfg.RenderConfig(n_samples=8, n_importance=8, ray_chunk=1024,
                                 **(render or {})),
        camera=tcfg.CameraConfig(**CAMERA),
        sampler=tcfg.SamplerConfig(n_samples_k=3, gumbel_temperature=1.0),
        detector=tcfg.DetectorConfig(num_classes=2, image_size=32, max_iter=2,
                                     images_per_batch=2, warmup_iters=1),
        bilevel=tcfg.BilevelConfig(**{
            "n_epochs": 4, "opt_lr": 2e-5, "opt_method": "momentum",
            "grad_e_max_images": 2, "grad_compute_dtype": "float32",
            "grad_ray_chunk": 288, **bilevel}),
        data=tcfg.DataConfig(save_pngs=False))


def jax_cfg(cfg: tcfg.NeuralSimConfig) -> jcfg.NeuralSimConfig:
    """The JAX package's config with the same field values."""
    sections = {}
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if dataclasses.is_dataclass(value):
            value = getattr(jcfg, type(value).__name__)(**dataclasses.asdict(value))
        sections[f.name] = value
    return jcfg.NeuralSimConfig(**sections)


@functools.lru_cache(maxsize=1)
def box_models():
    params = {k: np.array(v) for k, v in
              jax_box_scene(jcfg.NeRFNetConfig(**SMALL), jax.random.PRNGKey(0)).items()}
    return {"coarse": params, "fine": params}


@functools.lru_cache(maxsize=2)
def val_arrays(image_size: int = 32):
    """3 val images (a tail of 1 at batch 2) with one object each."""
    imgs = np.zeros((3, 24, 24, 3), np.float32)
    imgs[0, 4:14, 5:15] = 0.9
    imgs[1, 9:21, 2:12] = 0.7
    imgs[2, 2:10, 12:22] = 0.8
    dc = jcfg.DetectorConfig(num_classes=2, image_size=image_size)
    return tuple(np.asarray(x) for x in jds.build_detector_batches(imgs, [0, 1, 0], dc))


def jax_start_state(cfg: jcfg.NeuralSimConfig, psi_mode: str = "categorical"):
    """(psi, psi optimizer, detector state) for the JAX driver: carried
    detector weights, a nonzero momentum trace and step count, psi near
    uniform with nonzero momentum."""
    dc = cfg.detector
    _, flax = carried_params(tcfg.DetectorConfig(**dataclasses.asdict(dc)))
    trainable, _ = jt.split_trainable(flax, dc)
    opt_state = jt.make_detector_optimizer(dc).init(trainable)
    leaves, treedef = jax.tree_util.tree_flatten(opt_state)
    rs = np.random.RandomState(5)
    leaves = [jnp.asarray((1e-3 * rs.randn(*x.shape)).astype(np.float32)) if x.ndim
              else jnp.int32(3) for x in leaves]
    det = jt.DetectorState(flax, jax.tree_util.tree_unflatten(treedef, leaves), jnp.int32(3))
    rp = np.random.RandomState(6)
    if psi_mode == "gaussian":
        psi = jnp.asarray([150.0, 35.0], jnp.float32)
    else:
        psi = jnp.asarray(0.125 + 0.2 * rp.randn(8), jnp.float32)
    popt = jpsi_opt_init(cfg.bilevel.opt_method, cfg.bilevel.opt_lr, dim=psi.shape[0])
    popt = popt._replace(m=jnp.asarray(1e-3 * rp.randn(psi.shape[0]), jnp.float32))
    return psi, popt, det


def jax_draws(cfg: jcfg.NeuralSimConfig, key, n_train: int):
    """The JAX driver's epoch draws from ``key``, as its run_epoch splits
    it, in the port's EpochDraws (numpy -> tensors)."""
    _, k_noise, k_batch, k_hvp = jax.random.split(key, 4)
    sc, dc = cfg.sampler, cfg.detector
    if cfg.bilevel.psi_mode == "gaussian":
        noise = GaussianPoseNoise(*(torch.from_numpy(np.array(x)) for x in
                                    jposes.draw_pose_noise_gaussian(k_noise, sc)))
    else:
        noise = PoseNoise(*(torch.from_numpy(np.array(x)) for x in
                            jposes.draw_pose_noise(k_noise, sc)))
    batch_idx = np.array(jt.cycle_indices(n_train, dc.max_iter, dc.images_per_batch, k_batch))
    hvp_idx = np.array(jt.cycle_indices(n_train, 1, dc.images_per_batch, k_hvp)[0])
    return tdriver.EpochDraws(noise, torch.from_numpy(batch_idx), torch.from_numpy(hvp_idx))


def capture(log: dict, name: str, fn):
    """fn, recording its last arguments and result under log[name]."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        log[name] = (args, out)
        return out
    return wrapped


JAX_STAGES = ("_do_render", "_inner_train_fn", "_val_grad_fn", "_ihvp_fn", "_grad_e_fn")
PORT_STAGES = ("_render", "_val_grad", "_ihvp", "_grad_e")


def run_pair(cfg: tcfg.NeuralSimConfig, seed: int = 7, models=None, patch=None):
    """One epoch of each driver from one state with the same draws:
    {"jax": (record, captures, driver), "port": (...)}. ``patch(driver,
    side)`` may replace stage methods before the epoch."""
    models = models or box_models()
    jc = jax_cfg(cfg)
    val = val_arrays(cfg.detector.image_size)
    key = jax.random.PRNGKey(seed)
    jdrv = jdriver.BilevelDriver(jc, models, jdriver.ValData(*map(jnp.asarray, val)),
                                 key=key, object_class=1, output_dir=tempfile.mkdtemp())
    psi, popt, det = jax_start_state(jc, cfg.bilevel.psi_mode)
    state = jax.tree_util.tree_map(np.asarray, jdrv._ckpt_state(psi, popt, det, 0))
    # the JAX driver calibrates a production grid's budget on noise drawn
    # from fold_in(key, 0xCA1)
    cal = PoseNoise(*(torch.from_numpy(np.array(x)) for x in jposes.draw_pose_noise(
        jax.random.fold_in(key, 0xCA1), jc.sampler, num_k=8)))
    tdrv = tdriver.BilevelDriver(cfg, models, tdriver.ValData(*map(torch.from_numpy, val)),
                                 object_class=1, output_dir=tempfile.mkdtemp(),
                                 calibration_noise=cal, device="cpu")
    assert tdrv.rc_test == tcfg.RenderConfig(**dataclasses.asdict(jdrv.rc_test))
    tpsi, tpopt, tdet, epoch = tdriver.bilevel_state_from_jax(state, cfg.bilevel.opt_method)
    assert epoch == 0

    jcap, tcap = {}, {}
    for name in JAX_STAGES:
        setattr(jdrv, name, capture(jcap, name, getattr(jdrv, name)))
    for name in PORT_STAGES:
        setattr(tdrv, name, capture(tcap, name, getattr(tdrv, name)))
    if patch:
        patch(jdrv, "jax")
        patch(tdrv, "port")
    jrec = jdrv.run_epoch(0, psi, popt, det, save_pngs=False)
    draws = jax_draws(jc, key, cfg.sampler.n_samples_k)
    trec = tdrv.run_epoch(0, tpsi, tpopt, tdet, draws=draws)
    return {"jax": (jrec, jcap, jdrv), "port": (trec, tcap, tdrv), "state": state}


def flat(tree) -> np.ndarray:
    """A port dict (or a JAX tree, through params_from_flax) as one vector
    in name order."""
    if not all(isinstance(v, torch.Tensor) for v in tree.values()):
        tree = params_from_flax(jax.tree_util.tree_map(np.asarray, tree))
    return np.concatenate([tree[k].detach().numpy().reshape(-1) for k in sorted(tree)])


def norm_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def txt(drv) -> str:
    with open(drv.log.txt_path) as f:
        return f.read()


@pytest.fixture(scope="module")
def pair():
    return run_pair(port_cfg())


def test_whole_epoch_equals_jax(pair):
    jrec, jcap, jdrv = pair["jax"]
    trec, tcap, tdrv = pair["port"]
    # renders
    renders = tcap["_render"][1][0].numpy()
    want = np.asarray(jcap["_do_render"][1][0])
    assert renders.shape == (3, 24, 24, 3) and renders.max() > 0.1
    np.testing.assert_allclose(renders, want, rtol=0, atol=TOL)
    # the inner train's losses
    jloss = np.asarray(jcap["_inner_train_fn"][1][1]["loss"])
    assert np.isfinite(jloss).all()
    np.testing.assert_allclose(trec["inner_loss"], jloss[-1], rtol=TOL)
    # grad_E (influence_sign applied on both sides)
    jge = -np.asarray(jcap["_grad_e_fn"][1])
    tge = -tcap["_grad_e"][1].numpy()
    assert tge.shape == (2, 24, 24, 3)
    assert norm_err(tge, jge) < TOL
    # grad_psi, large enough to compare
    g, jg = trec["grad_psi"], np.asarray(jrec["grad_psi"])
    assert np.linalg.norm(jg) > 1e-4 and np.isfinite(g).all()
    assert norm_err(g, jg) < GRAD_PSI_TOL
    # psi after the step, its optimizer, the log
    np.testing.assert_allclose(trec["psi"].numpy(), np.asarray(jrec["psi"]), rtol=0,
                               atol=PSI_TOL)
    assert not np.allclose(trec["psi"].numpy(), pair["state"]["psi"])
    np.testing.assert_allclose(trec["psi_opt"].m.numpy(), np.asarray(jrec["psi_opt"].m),
                               rtol=1e-3, atol=1e-8)
    assert float(trec["psi_opt"].lr) == float(jrec["psi_opt"].lr) == 0.0   # epoch 0 of warmup
    np.testing.assert_allclose(trec["psi_probs"], np.asarray(jrec["psi_probs"]), atol=PSI_TOL)
    assert np.isclose(trec["psi_probs"].sum(), 1.0, rtol=1e-5)
    same_result(trec["map"], jrec["map"])
    assert txt(tdrv) == txt(jdrv)
    assert len(txt(tdrv).splitlines()) == 2
    # the detector after the inner train, momentum and step included
    tstate, jstate = trec["detector_state"], jrec["detector_state"]
    assert int(tstate.step) == int(jstate.step) == 5
    assert norm_err(flat(tstate.params), flat(jstate.params)) < TOL


def test_val_grad_padded_tail_equals_jax(pair):
    """v over 3 val images at batch 2: two batches, the tail zero-padded and
    masked; on the JAX stage's input parameters."""
    _, jcap, _ = pair["jax"]
    _, _, tdrv = pair["port"]
    (jparams,), jv = jcap["_val_grad_fn"]
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    v = tdrv._val_grad(params)
    assert "backbone.res2_block0.conv1.weight" not in v
    assert norm_err(flat(v), flat(jv)) < TOL
    # the padded tail adds exactly what a smaller final batch would
    from neuralsim_tpu_torch.detector.trainer import split_trainable
    from neuralsim_tpu_torch.hypergrad.influence import grad_loss

    trainable, frozen = split_trainable(params, tdrv.cfg.detector)
    val = tdrv.val_data
    batches = [DetBatch(*(x[s:e] for x in val)) for s, e in ((0, 2), (2, 3))]
    want = grad_loss(lambda tp, b: tdrv._det_loss_trainable(tp, frozen, b), trainable, batches)
    assert norm_err(flat(v), flat(want)) < 1e-5


def test_ihvp_and_grad_e_equal_jax(pair):
    """The inverse HVP (onestep) and grad_E on the JAX stages' inputs."""
    _, jcap, _ = pair["jax"]
    _, _, tdrv = pair["port"]
    (jparams, jbatch, jv), jihvp = jcap["_ihvp_fn"]
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    v = params_from_flax(jax.tree_util.tree_map(np.asarray, jv))
    batch = DetBatch(*(torch.from_numpy(np.array(x)) for x in jbatch))
    ihvp = tdrv._ihvp(params, batch, v)
    assert norm_err(flat(ihvp), flat(jihvp)) < TOL
    (_, renders, boxes, labels, valid, jih), jge = jcap["_grad_e_fn"]
    ge = tdrv._grad_e(params, *(torch.from_numpy(np.array(x)) for x in
                                (renders, boxes, labels, valid)),
                      params_from_flax(jax.tree_util.tree_map(np.asarray, jih)))
    assert np.abs(np.asarray(jge)).max() > 0
    assert norm_err(ge.numpy(), np.asarray(jge)) < TOL


def test_evaluate_with_tail_equals_jax(pair, monkeypatch):
    """mAP over the 3 val images at batch 2 (the JAX driver pads the tail),
    with detections above the score threshold: the detections handed to
    coco_map (labels and order equal, boxes and scores 1e-4) and the
    result."""
    _, _, jdrv = pair["jax"]
    _, _, tdrv = pair["port"]
    flax = jax.tree_util.tree_map(np.asarray, pair["state"]["detector"]["params"])
    flax["head"]["cls_score"]["kernel"] = flax["head"]["cls_score"]["kernel"] * CLS_KERNEL_SCALE
    seen = {}
    for side, module in (("jax", jdriver), ("port", tdriver)):
        monkeypatch.setattr(module, "coco_map", capture(seen, side, module.coco_map))
    want = jdrv.evaluate(jt.DetectorState(jax.tree_util.tree_map(jnp.asarray, flax), None,
                                          None))
    from neuralsim_tpu_torch.detector.trainer import DetectorState

    got = tdrv.evaluate(DetectorState(params_from_flax(flax), None, None))
    (jdets, jgt), _ = seen["jax"]
    (tdets, tgt), _ = seen["port"]
    assert len(tdets) == len(jdets) == 3
    assert sum(len(d["scores"]) for d in jdets) > 30
    for t, j in zip(tdets, jdets):
        np.testing.assert_array_equal(t["labels"], j["labels"])
        np.testing.assert_allclose(t["scores"], j["scores"], rtol=0, atol=TOL)
        np.testing.assert_allclose(t["boxes"], j["boxes"], rtol=0, atol=TOL * 32)
    for t, j in zip(tgt, jgt):
        np.testing.assert_array_equal(t["boxes"], j["boxes"])
        np.testing.assert_array_equal(t["labels"], j["labels"])
    same_result(got, want)


def test_draw_epoch_order_and_shapes():
    """The port's own draws: noise, schedule, HVP batch, in that order from
    the driver's generator (the same generator state draws the same
    epoch)."""
    cfg = port_cfg()
    val = tdriver.ValData(*map(torch.from_numpy, val_arrays()))
    drv = tdriver.BilevelDriver(cfg, box_models(), val, output_dir=tempfile.mkdtemp(),
                                device="cpu")
    state = drv.generator.get_state()
    a = drv.draw_epoch()
    drv.generator.set_state(state)
    b = drv.draw_epoch()
    for x, y in zip((*a.noise, a.batch_idx, a.hvp_idx), (*b.noise, b.batch_idx, b.hvp_idx)):
        assert torch.equal(x, y)
    assert a.batch_idx.shape == (2, 2) and a.hvp_idx.shape == (2,)
    assert a.noise.gumbel.shape == (3, 8)
    assert sorted(a.batch_idx.reshape(-1).tolist())[:3] == [0, 1, 2]
    c = drv.draw_epoch()
    assert not torch.equal(c.noise.gumbel, a.noise.gumbel)


def test_driver_raises_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    val = tdriver.ValData(*map(torch.from_numpy, val_arrays()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdriver.BilevelDriver(port_cfg(), box_models(), val, output_dir=tempfile.mkdtemp())


def test_streamed_val_set_equals_device_resident(pair):
    """eval_stream_images > 0: the val set stays on the host and streams in
    chunks (2 images a chunk here, a padded tail); v and mAP equal the
    device-resident forms' (the same per-batch terms)."""
    _, _, tdrv = pair["port"]
    cfg = tdrv.cfg
    scfg = cfg.replace(detector=dataclasses.replace(cfg.detector, eval_stream_images=2))
    sdrv = tdriver.BilevelDriver(scfg, box_models(),
                                 tdriver.ValData(*map(torch.from_numpy, val_arrays())),
                                 output_dir=tempfile.mkdtemp(), device="cpu")
    assert sdrv.streaming and not tdrv.streaming
    params = {k: v.clone() for k, v in pair["port"][0]["detector_state"].params.items()}
    params["head.cls_score.weight"] = params["head.cls_score.weight"] * CLS_KERNEL_SCALE
    assert norm_err(flat(sdrv._val_grad(params)), flat(tdrv._val_grad(params))) < 1e-6
    from neuralsim_tpu_torch.detector.trainer import DetectorState

    state = DetectorState(params, None, None)
    same_result(sdrv.evaluate(state), tdrv.evaluate(state))
