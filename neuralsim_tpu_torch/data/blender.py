"""LINEMOD/Blender-format dataset and camera loaders (reference
``optimization/utils/load_LINEMOD_noscale.py``; the port of
``neuralsim_tpu/data/blender.py``).

- ``load_linemod_data`` reads ``transforms_{train,val,test}.json`` in the
  repository's extended NeRF-Blender format (absolute file_path, 4x4
  transform_matrix, per-frame intrinsic_matrix), keeps RGBA, takes testskip
  and half_res (/2 with K rescaled), and widens near/far by -/+1
  (reference :97-163). Frames are read with the port's own PNG reader.
- ``load_data_param`` reads only ``nerf_traindata_info.json`` for the
  pipeline (reference :166-199).
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np


class CameraParams(NamedTuple):
    height: int
    width: int
    focal: float
    K: np.ndarray       # [3,3]
    near: float
    far: float


class LinemodDataset(NamedTuple):
    images: np.ndarray      # [N, H, W, 4] float32 in [0,1]
    poses: np.ndarray       # [N, 4, 4]
    render_poses: np.ndarray
    camera: CameraParams
    i_split: tuple          # (train_idx, val_idx, test_idx)


def _area_resize_half(img: np.ndarray, factor: int) -> np.ndarray:
    """INTER_AREA-equivalent downscale for integer factors: mean pooling."""
    h, w = img.shape[:2]
    nh, nw = h // factor, w // factor
    img = img[: nh * factor, : nw * factor]
    return img.reshape(nh, factor, nw, factor, -1).mean(axis=(1, 3))


def load_linemod_data(basedir: str, half_res: bool = False, testskip: int = 1,
                      n_render_poses: int = 40) -> LinemodDataset:
    """The train, val and test frames of a LINEMOD-layout directory with
    their poses, the camera, the split indices and ``n_render_poses``
    spiral poses (elevation -30, radius 1.01, float32)."""
    import torch

    from neuralsim_tpu_torch.sampler.poses import pose_spherical
    from neuralsim_tpu_torch.utils.png import read_png

    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if (s == "train" or testskip == 0) else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            imgs.append(read_png(frame["file_path"]))
            poses.append(np.array(frame["transform_matrix"]))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)  # keep RGBA
        poses = np.array(poses).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)

    i_split = tuple(np.arange(counts[i], counts[i + 1]) for i in range(3))
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    K = np.array(metas["test"]["frames"][0]["intrinsic_matrix"], np.float64)
    focal = float(K[0, 0])

    angles = np.linspace(-180, 180, n_render_poses + 1)[:-1]
    render_poses = pose_spherical(torch.tensor(angles, dtype=torch.float32),
                                  torch.full((len(angles),), -30.0), 1.01).numpy()

    if half_res:
        factor = 2
        K = K / factor
        K[2, 2] = 1.0
        H, W = H // factor, W // factor
        focal = focal / factor
        imgs = np.stack([_area_resize_half(im, factor) for im in imgs], 0)

    near = min(metas["train"]["near"], metas["test"]["near"]) - 1.0
    far = max(metas["train"]["far"], metas["test"]["far"]) + 1.0

    cam = CameraParams(int(H), int(W), focal, K.astype(np.float32), near, far)
    return LinemodDataset(imgs.astype(np.float32), poses, render_poses, cam, i_split)


def load_data_param(datadir: str, half_res: bool = False,
                    half_res_factor: int = 4,
                    info_name: str = "nerf_traindata_info.json") -> CameraParams:
    """Camera of ``nerf_traindata_info.json``.

    half_res divides by ``half_res_factor`` = 4 by default: the reference
    divides by 4 here and by 2 in its full dataset loader, and the pipeline
    depends on the resulting 100x100 renders. near/far widen by -/+0.5.
    """
    with open(os.path.join(datadir, info_name)) as fp:
        info = json.load(fp)
    sample = info["frames"][0]
    H, W = info["H"], info["W"]
    K = np.array(sample["intrinsic_matrix"], np.float64)
    focal = float(K[0, 0])
    if half_res:
        K = K / half_res_factor
        K[2, 2] = 1.0
        H, W = H // half_res_factor, W // half_res_factor
        focal = focal / half_res_factor
    return CameraParams(
        int(H), int(W), focal, K.astype(np.float32),
        info["near"] - 0.5, info["far"] + 0.5,
    )
