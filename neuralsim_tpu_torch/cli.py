"""Command-line entry point with the reference's surface (the port of
``neuralsim_tpu/cli.py``).

``python -m neuralsim_tpu_torch.cli --config configs/nerf_param_ycbv_general.txt
--expname ycbv2_01 --object_id 2 --psi_pose_cats_mode 5 --test_distribution
one_1`` mirrors the reference invocation (``README.md:104-117`` /
``optimization/neural_sim_main.py:1363-1383``): build the renderer and the
detector's data, then run the bilevel optimization. It runs on the card;
``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None, cfg=None, device=None):
    from neuralsim_tpu_torch import resolve_device
    from neuralsim_tpu_torch.bilevel.driver import BilevelDriver
    from neuralsim_tpu_torch.config import parse_cli
    from neuralsim_tpu_torch.pipeline import NeuralSimRenderer
    from neuralsim_tpu_torch.utils.logging import save_args_snapshot

    if cfg is None:
        parser = argparse.ArgumentParser("neuralsim_tpu_torch.cli", add_help=False)
        parser.add_argument("--device", type=str, default=None)
        known, argv = parser.parse_known_args(argv)
        device = device if device is not None else known.device
        cfg = parse_cli(argv)
    device = resolve_device(device)

    expdir = os.path.join(cfg.data.basedir, cfg.data.expname)
    os.makedirs(expdir, exist_ok=True)
    save_args_snapshot(expdir, cfg)

    renderer = NeuralSimRenderer(cfg, generator=torch.Generator().manual_seed(cfg.seed),
                                 device=device)
    val_data, object_class, bg_images, bg_labels = _load_detector_data(cfg, device)

    driver = BilevelDriver(
        cfg, renderer.models, val_data, generator=torch.Generator().manual_seed(cfg.seed),
        object_class=object_class, background_images=bg_images,
        background_labels=bg_labels, device=device)
    result = driver.run()
    print("final psi:", result["psi"].detach().cpu().numpy())
    return result


def _load_detector_data(cfg, device):
    """Load the val distribution + background-class train images from the
    reference directory layout (configs/ycb_synthetic_train_val_path_info.json)
    when present; otherwise a minimal single-class setup."""
    import json

    from neuralsim_tpu_torch.bilevel.driver import ValData
    from neuralsim_tpu_torch.detector.dataset import build_detector_batches

    path_info = cfg.data.train_val_path_info
    dc = cfg.detector
    if os.path.exists(path_info):
        with open(path_info) as f:
            info = json.load(f)
        class_names = sorted(info["train_info"].keys(), key=lambda s: (len(s), s))
        class_to_idx = {c: i for i, c in enumerate(class_names)}
        object_class = class_to_idx[cfg.data.object_id]

        test_dirs = info["test_info"][cfg.data.test_distribution]
        val_imgs, val_labels = _read_class_dirs(test_dirs, class_to_idx, cfg.data.basedir)
        bg_dirs = {c: d for c, d in info["train_info"].items() if c != cfg.data.object_id}
        bg_imgs, bg_labels = _read_class_dirs(bg_dirs, class_to_idx, cfg.data.basedir)
    else:
        object_class = 0
        val_imgs, val_labels = np.zeros((0, 8, 8, 3), np.float32), []
        bg_imgs, bg_labels = None, None

    if len(val_imgs):
        val = ValData(*build_detector_batches(val_imgs, val_labels, dc, device=device))
    else:
        s = dc.image_size
        val = ValData(torch.zeros((1, s, s, 3), device=device),
                      torch.zeros((1, 1, 4), device=device),
                      torch.zeros((1, 1), dtype=torch.int64, device=device),
                      torch.zeros((1, 1), dtype=torch.bool, device=device))
    if bg_imgs is not None and len(bg_imgs) == 0:
        bg_imgs, bg_labels = None, None
    return val, object_class, bg_imgs, bg_labels


def _read_class_dirs(dirs, class_to_idx, basedir):
    import imageio.v2 as imageio

    images, labels = [], []
    for cname, d in dirs.items():
        full = d if os.path.isabs(d) else os.path.join(basedir, d)
        if not os.path.isdir(full):
            continue
        for f in sorted(os.listdir(full)):
            if f.endswith(".png"):
                img = np.asarray(imageio.imread(os.path.join(full, f)), np.float32) / 255.0
                images.append(img[..., :3])
                labels.append(class_to_idx[cname])
    if not images:
        return np.zeros((0, 8, 8, 3), np.float32), []
    return np.stack(images), labels


if __name__ == "__main__":
    main()
