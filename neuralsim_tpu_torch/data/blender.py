"""Pipeline-mode camera loader (reference load_LINEMOD_noscale.py:166-199)."""

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
