"""The plain reference against the program's plain path at a tiny size on
the CPU, where the program runs no kernel: the render, the strips
gradient, the detector's inner train, the inverse HVP and grad_E, and the
NeRF train step. On the card the same comparison, at the cells' sizes, is
what decides each run's ``correct``."""

import dataclasses

import pytest
import torch

from bench_port.cells import reference_config, program_config, tree_rel_l2
from bench_port.tests.tiny import tiny

CELL = "bilevel.nerf256.k50"


@pytest.fixture(scope="module")
def setting():
    torch.manual_seed(0)
    w, c = tiny(CELL)
    from bench_port.reference.box_scene import box_scene_params, textured_box_params
    from bench_port.reference.nerf import init_nerf_params

    rcfg, cfg = reference_config(c, w), program_config(c, w)
    g = torch.Generator().manual_seed(5)
    box = box_scene_params(rcfg.net, generator=g)
    rnd = {"coarse": init_nerf_params(rcfg.net, False, g), "fine": init_nerf_params(rcfg.net, True, g)}
    tex = textured_box_params(rcfg.net, generator=g)
    return rcfg, cfg, {"coarse": box, "fine": box}, rnd, {"coarse": tex, "fine": tex}


def _poses(rcfg, k=2, seed=3):
    from bench_port.reference.poses import draw_pose_noise, poses_from_noise, psi_to_probs
    from bench_port.reference.psi_init import psi_init

    noise = draw_pose_noise(torch.Generator().manual_seed(seed), rcfg.sampler, k)
    return psi_init("5"), noise, poses_from_noise(psi_to_probs(psi_init("5"), rcfg.sampler),
                                                  noise, rcfg.sampler)


@pytest.mark.parametrize("weights", ["box", "textured", "random"])
def test_render_matches_program(setting, weights):
    from neuralsim_tpu_torch.ops.render import render_poses as program_render

    from bench_port.reference.render import render_poses

    rcfg, cfg, box, rnd, tex = setting
    models = {"box": box, "textured": tex, "random": rnd}[weights]
    _, _, poses = _poses(rcfg)
    cam = rcfg.camera
    want = program_render(models, poses, cam.height, cam.width, cam.K, cfg.net,
                          cfg.render.test_mode(), device="cpu")["rgb_map"]
    got = render_poses(models, poses, cam.height, cam.width, cam.K, rcfg.net,
                       dataclasses.replace(rcfg.render, perturb=False), block=37)["rgb_map"]
    assert float((got - want).abs().max()) < 1e-5


def test_strips_gradient_matches_program(setting):
    from neuralsim_tpu_torch.hypergrad.render_grad import render_grad_psi_strips

    from bench_port.reference.render_grad import image_grads

    rcfg, cfg, box, _, _ = setting
    psi, noise, _ = _poses(rcfg, k=2, seed=7)
    cam = rcfg.camera
    ge = torch.randn((2, cam.height, cam.width, 3), generator=torch.Generator().manual_seed(1))
    rc = dataclasses.replace(rcfg.render, perturb=False)
    got = image_grads(box, psi, noise, ge, cam.height, cam.width, cam.K, rcfg.net, rc,
                      rcfg.sampler, strip=100).mean(0)
    from neuralsim_tpu_torch.sampler.poses import PoseNoise

    want = render_grad_psi_strips(box, psi, PoseNoise(*noise), ge, cam.height, cam.width, cam.K,
                                  cfg.net, cfg.render.test_mode(), cfg.sampler, strip=100)
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) < 1e-4


@pytest.fixture(scope="module")
def detector(setting):
    """Both sides' inner train from one init, on one dataset."""
    from neuralsim_tpu_torch.detector import trainer as program

    from bench_port.reference import detector as reference
    from bench_port.reference.dataset import build_detector_batches_device
    from bench_port.reference.render import render_poses
    from bench_port.reference.retinanet import DetBatch, generate_anchors

    rcfg, cfg, box, _, _ = setting
    _, _, poses = _poses(rcfg, k=4, seed=11)
    cam, dc = rcfg.camera, rcfg.detector
    rgb = render_poses(box, poses, cam.height, cam.width, cam.K, rcfg.net,
                       dataclasses.replace(rcfg.render, perturb=False))["rgb_map"]
    data = DetBatch(*build_detector_batches_device(rgb, [1] * 4, dc))
    anchors = torch.cat(generate_anchors(dc.image_size, "cpu"), dim=0)
    idx = reference.cycle_indices(4, dc.max_iter, dc.images_per_batch,
                                  torch.Generator().manual_seed(2))
    state0 = reference.init_detector(torch.Generator().manual_seed(4), dc, device="cpu")
    ref, _ = reference.inner_train(state0, data, idx, dc, anchors)
    params = dict(state0.params)
    trainable, _ = program.split_trainable(params, cfg.detector)
    pstate = program.DetectorState(params, program.make_detector_optimizer(cfg.detector)
                                   .init(trainable), torch.zeros((), dtype=torch.int32))
    prog, _ = program.inner_train(pstate, (data, idx), cfg.detector, anchors)
    return rcfg, cfg, state0.params, ref.params, prog.params, data, rgb


def test_inner_train_matches_program(detector):
    _, _, p0, ref, prog, _, _ = detector
    keys = [k for k in ref if not k.startswith("backbone.")]
    change = {k: ref[k] - p0[k] for k in keys}
    assert tree_rel_l2({k: prog[k] - p0[k] for k in keys}, change) < 1e-5
    assert max(float(v.abs().max()) for v in change.values()) > 0


def test_ihvp_and_grad_e_match_program(detector):
    from neuralsim_tpu_torch.detector import trainer as program
    from neuralsim_tpu_torch.hypergrad import influence as pinf
    from neuralsim_tpu_torch.models.retinanet import retinanet_loss as p_loss

    from bench_port.reference import detector as reference
    from bench_port.reference import influence as rinf
    from bench_port.reference.dataset import prepare_images
    from bench_port.reference.retinanet import DetBatch, generate_anchors, retinanet_loss

    rcfg, cfg, _, theta, _, data, rgb = detector
    dc = rcfg.detector
    anchors = torch.cat(generate_anchors(dc.image_size, "cpu"), dim=0)
    rtr, rfr = reference.split_trainable(theta, dc)
    _, rapply = reference.make_detector_apply(dc)
    _, papply = program.make_detector_apply(cfg.detector)

    def rloss(tp, b):
        return retinanet_loss(rapply, {**tp, **rfr}, b, anchors, dc)[0]

    def ploss(tp, b):
        return p_loss(papply, {**tp, **rfr}, b, anchors, cfg.detector)[0]

    v = rinf.grad_loss(rloss, rtr, [data])
    got = rinf.inverse_hvp_onestep(rloss, rtr, data, v)
    want = pinf.inverse_hvp(ploss, rtr, data, pinf.grad_loss(ploss, rtr, [data]))
    assert tree_rel_l2(got, want) < 1e-5

    def rimg(tp, r):
        return rloss(tp, DetBatch(prepare_images(r[None], dc), *(x[:1] for x in data[1:])))

    def pimg(tp, r):
        return ploss(tp, DetBatch(prepare_images(r[None], dc), *(x[:1] for x in data[1:])))

    ge_r = rinf.mixed_grad_wrt_images(rimg, rtr, rgb[:1], got)
    ge_p = pinf.mixed_grad_wrt_images(pimg, rtr, rgb[:1], got)
    assert float(torch.linalg.norm(ge_r - ge_p) / torch.linalg.norm(ge_p)) < 1e-5


def test_train_step_matches_program(setting):
    from neuralsim_tpu_torch.train_nerf import (
        TrainState, make_optimizer, sample_image_rays, train_step)

    from bench_port.reference.train import adam_init, pixel_rays, step

    rcfg, cfg, box, rnd, _ = setting
    cam = rcfg.camera
    _, _, poses = _poses(rcfg, k=1, seed=13)
    from bench_port.reference.render import render_poses

    image = render_poses(box, poses, cam.height, cam.width, cam.K, rcfg.net,
                         dataclasses.replace(rcfg.render, perturb=False))["rgb_map"][0]
    rc = dataclasses.replace(rcfg.render, perturb=True)
    g = torch.Generator().manual_seed(17)
    state0 = g.get_state()
    ro, rd, tgt = pixel_rays(image, poses[0], cam.height, cam.width, cam.K, 64, g)
    params, opt, loss, _ = step(rnd, adam_init(rnd), ro, rd, tgt, rcfg.net, rc, rcfg.train, g)
    g.set_state(state0)
    pro, prd, ptgt = sample_image_rays(image, poses[0], cam.height, cam.width, cam.K, 64,
                                       generator=g)
    assert torch.equal(pro, ro) and torch.equal(ptgt, tgt)
    state = TrainState(rnd, make_optimizer(cfg.train).init(rnd), torch.zeros((), dtype=torch.int32))
    new, metrics = train_step(state, pro, prd, ptgt, cfg.net,
                              dataclasses.replace(cfg.render, perturb=True), cfg.train,
                              generator=g)
    assert abs(float(metrics["loss"]) - float(loss)) <= 1e-6 * float(loss)
    for m in params:
        for k in params[m]:
            assert torch.allclose(new.params[m][k], params[m][k], rtol=0, atol=1e-6)
