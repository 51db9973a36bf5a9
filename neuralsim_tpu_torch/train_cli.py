"""Standalone NeRF training entry point (the port of
``neuralsim_tpu/train_cli.py``; reference trainer CLI
``optimization/utils/run_nerf_noscale.py:503-796``): train on a
LINEMOD/Blender dataset with per-image ray sampling (+ precrop) or the ray
pool, periodic checkpoints, spiral renders and test-set dumps, and the
``render_only`` short-circuit. Usage::

    python -m neuralsim_tpu_torch.train_cli --config configs/nerf_param.txt \\
        --datadir data/cheesebox --expname cheesebox_run [--device cpu]

It runs on the card, in float32 with TF32 off and deterministic cuDNN
algorithms (``set_card_numerics``); ``--device cpu`` runs it on the CPU.
Frames are read and test renders written as PNG with ``utils/png.py``. The
spiral is an mp4 (or a gif) where imageio is installed; where it is not it
is a directory of PNG frames, and the result and the printed line say that
no video was written.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch


class SpiralRender(NamedTuple):
    path: str        # the video file, or the directory of PNG frames
    video: bool      # False: no video was written (no imageio), frames only


def render_spiral_video(models, dataset, net, rc, out_path: str, fps: int = 30,
                        device=None) -> SpiralRender:
    """Render the dataset's spiral poses (reference i_video dumps,
    run_nerf_noscale.py:733-740) and write an mp4, a gif where the mp4
    fails, or, without imageio, the frames as PNGs in a directory named
    after out_path."""
    from neuralsim_tpu_torch.ops.render import render_poses, to8b
    from neuralsim_tpu_torch.utils.png import write_png

    cam = dataset.camera
    with torch.no_grad():
        out = render_poses(models, np.asarray(dataset.render_poses), cam.height, cam.width,
                           cam.K, net, rc.test_mode(), device=device)
    frames = [to8b(f) for f in out["rgb_map"].cpu().numpy()]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    try:
        import imageio.v2 as imageio
    except ImportError:
        frame_dir = os.path.splitext(out_path)[0] + "_frames"
        os.makedirs(frame_dir, exist_ok=True)
        for i, frame in enumerate(frames):
            write_png(os.path.join(frame_dir, f"{i:03d}.png"), frame)
        print(f"spiral: imageio is not installed, no video written; {len(frames)} PNG "
              f"frames in {frame_dir}")
        return SpiralRender(frame_dir, False)
    try:
        imageio.mimwrite(out_path, frames, fps=fps, quality=8)
    except Exception:  # imageio without ffmpeg: fall back to a gif
        alt = os.path.splitext(out_path)[0] + ".gif"
        imageio.mimwrite(alt, frames, duration=1.0 / fps)
        return SpiralRender(alt, True)
    return SpiralRender(out_path, True)


def render_testset(models, dataset, net, rc, out_dir: str, device=None) -> float:
    """Render the held-out test poses to PNGs and return their mean PSNR
    against the ground truth (reference i_testset dumps,
    run_nerf_noscale.py:749-756)."""
    from neuralsim_tpu_torch.ops.render import render_poses, to8b
    from neuralsim_tpu_torch.utils.png import write_png

    cam = dataset.camera
    test_idx = dataset.i_split[2]
    os.makedirs(out_dir, exist_ok=True)
    if len(test_idx) == 0:
        return float("nan")
    with torch.no_grad():
        out = render_poses(models, np.asarray(dataset.poses[test_idx]), cam.height, cam.width,
                           cam.K, net, rc.test_mode(), device=device)
    rgbs = out["rgb_map"].cpu().numpy()
    psnrs = []
    for i, idx in enumerate(test_idx):
        write_png(os.path.join(out_dir, f"{i:03d}.png"), to8b(rgbs[i]))
        gt = dataset.images[idx][..., :3]
        mse = float(np.mean((rgbs[i] - gt) ** 2))
        psnrs.append(-10.0 * np.log10(max(mse, 1e-10)))
    return float(np.mean(psnrs))


def restore_params(cfg, expdir: str, device):
    """Pretrained params as the reference's create_nerf resolves them
    (run_nerf_noscale.py:295-315): an explicit ``ft_path`` (.npz or a
    reference .tar) wins, else the latest checkpoint in
    ``{expdir}/checkpoints`` (the port's, or the JAX package's npz).
    Returns (models or None, global step)."""
    from neuralsim_tpu_torch.models.convert import (
        load_nerf_checkpoint,
        load_params_npz,
        params_from_numpy,
    )
    from neuralsim_tpu_torch.models.nerf import init_nerf_pipeline_params
    from neuralsim_tpu_torch.utils.checkpoint import CheckpointManager

    ft = cfg.data.ft_path
    if ft:
        if ft.endswith(".npz"):
            return params_from_numpy(load_params_npz(ft), device), 0
        models, step = load_nerf_checkpoint(ft)
        return params_from_numpy(models, device), step
    ckpt = CheckpointManager(os.path.join(expdir, "checkpoints"))
    step = ckpt.latest_step()
    if step is None:
        return None, 0
    like = {"params": init_nerf_pipeline_params(cfg.net, cfg.render.n_importance,
                                                device=device)}
    return params_from_numpy(ckpt.restore(step, like=like)["params"], device), step


def main(argv=None, device=None):
    from neuralsim_tpu_torch import resolve_device, set_card_numerics
    from neuralsim_tpu_torch.config import parse_cli
    from neuralsim_tpu_torch.data.blender import load_linemod_data
    from neuralsim_tpu_torch.train_nerf import TrainState, init_train_state, train_nerf
    from neuralsim_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        save_nerf_tar_compatible,
    )
    from neuralsim_tpu_torch.utils.logging import save_args_snapshot

    parser = argparse.ArgumentParser("neuralsim_tpu_torch.train_cli", add_help=False)
    parser.add_argument("--device", type=str, default=None)
    known, argv = parser.parse_known_args(argv)
    device = resolve_device(device if device is not None else known.device)
    set_card_numerics(device)
    cfg = parse_cli(argv)
    tc = cfg.train
    generator = torch.Generator(device=device).manual_seed(cfg.seed)

    expdir = os.path.join(cfg.data.basedir, cfg.data.expname)
    os.makedirs(expdir, exist_ok=True)
    save_args_snapshot(expdir, cfg)

    dataset = load_linemod_data(cfg.data.datadir, cfg.data.half_res, cfg.data.testskip)
    rc = dataclasses.replace(cfg.render, near=dataset.camera.near, far=dataset.camera.far)

    if tc.render_only:
        # reference :582-602: no training; render the spiral path (or the
        # held-out test set with render_test) from the restored checkpoint
        # into renderonly_{path|test}_{start:06d}/
        models, start = restore_params(cfg, expdir, device)
        if models is None:
            raise SystemExit("render_only requires a checkpoint: set --ft_path or train "
                             f"first (no checkpoints under {expdir}/checkpoints)")
        tag = "test" if tc.render_test else "path"
        out_dir = os.path.join(expdir, f"renderonly_{tag}_{start:06d}")
        if tc.render_test:
            psnr = render_testset(models, dataset, cfg.net, rc, out_dir, device)
            print(f"render_only: test set -> {out_dir} PSNR={psnr:.2f}")
        else:
            spiral = render_spiral_video(models, dataset, cfg.net, rc,
                                         os.path.join(out_dir, "video.mp4"), device=device)
            print(f"render_only: spiral -> {spiral.path}"
                  + ("" if spiral.video else " (PNG frames, no video)"))
        return None

    ckpt = CheckpointManager(os.path.join(expdir, "checkpoints"))
    init_models, start = restore_params(cfg, expdir, device)
    state0 = None
    if init_models is not None:
        fresh = init_train_state(cfg.net, rc, tc, generator, device)
        state0 = TrainState(init_models, fresh.opt_state,
                            torch.tensor(start, dtype=torch.int32, device=device))

    def save(i: int, state: TrainState):
        ckpt.save(i, {"params": state.params})
        save_nerf_tar_compatible(os.path.join(expdir, f"{i:06d}.tar"), state.params,
                                 global_step=i)

    def periodic(i: int, state: TrainState):
        # the reference's in-loop artifact cadence (:723-756): .tar every
        # i_weights, spiral every i_video, test-set renders every i_testset
        if tc.i_weights and i % tc.i_weights == 0:
            save(i, state)
        if tc.i_video and i % tc.i_video == 0:
            render_spiral_video(state.params, dataset, cfg.net, rc,
                                os.path.join(expdir, f"spiral_{i:06d}.mp4"), device=device)
        if tc.i_testset and i % tc.i_testset == 0:
            render_testset(state.params, dataset, cfg.net, rc,
                           os.path.join(expdir, f"testset_{i:06d}"), device)

    state, metrics = train_nerf(dataset, cfg.net, rc, tc, generator, log_every=tc.i_print,
                                hook=periodic, state=state0, device=device)

    step = int(state.step)
    save(step, state)
    spiral = render_spiral_video(state.params, dataset, cfg.net, rc,
                                 os.path.join(expdir, f"spiral_{step:06d}.mp4"), device=device)
    psnr = render_testset(state.params, dataset, cfg.net, rc, os.path.join(expdir, "testset"),
                          device)
    print(f"done: step={step} test PSNR={psnr:.2f} "
          + (f"video={spiral.path}" if spiral.video else
             f"no video written, PNG frames in {spiral.path}"))
    return state


if __name__ == "__main__":
    main()
