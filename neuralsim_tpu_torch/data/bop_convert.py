"""Offline BOP -> NeRF-Blender dataset converters (the port's own copy of
``neuralsim_tpu/data/bop_convert.py``, which uses no framework).

Capability parity with the reference's data generators
(``data/data_generatation-Blender.py`` / ``data_generation-LINEMOD.py``):
walk BlenderProc BOP output (``train_pbr/000000/rgb`` + ``scene_camera.json``),
convert world-to-camera to camera-to-world, mm -> m, flip OpenCV camera axes
to OpenGL (negate Y/Z columns), derive near/far from camera distance and the
object diameter, and write ``transforms_{train,val,test}.json`` with
per-frame intrinsics — the format the LINEMOD loader consumes.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

# YCB-V object diameters in mm (BOP models_info; reference
# data_generatation-Blender.py:21-37 hard-codes the same table)
YCBV_DIAMETERS_MM = {
    1: 172.063, 2: 269.573, 3: 198.377, 4: 120.543, 5: 196.463,
    6: 89.797, 7: 142.543, 8: 114.053, 9: 129.540, 10: 197.796,
    11: 259.534, 12: 259.566, 13: 161.922, 14: 124.990, 15: 226.170,
    16: 237.299, 17: 203.973, 18: 121.365, 19: 174.746, 20: 217.094,
    21: 102.903,
}

YCBV_NAMES = {
    1: "masterchefcan", 2: "cheesebox", 3: "sugarbox", 4: "tomatosoupcan",
    5: "mustardbottle", 6: "tunafishcan", 7: "puddingbox", 8: "gelatinbox",
    9: "pottedmeatcan", 10: "banana", 11: "pitcherbase", 12: "bleachcleanser",
    13: "bowl", 14: "mug", 15: "drill", 16: "woodblock", 17: "scissors",
    18: "largemarker", 19: "largeclamp", 20: "extralargeclamp", 21: "foambrick",
}

# OpenCV (x right, y down, z forward) -> OpenGL (x right, y up, z backward)
_CV2GL = np.diag([1.0, -1.0, -1.0])


def w2c_to_c2w_gl(R_w2c: np.ndarray, t_w2c_mm: np.ndarray) -> np.ndarray:
    """BOP scene_camera cam_R_w2c/cam_t_w2c (mm) -> OpenGL c2w (m)."""
    R = np.asarray(R_w2c, np.float64).reshape(3, 3)
    t = np.asarray(t_w2c_mm, np.float64).reshape(3) / 1000.0
    c2w = np.eye(4)
    c2w[:3, :3] = R.T @ _CV2GL  # invert rotation, then flip camera Y/Z axes
    c2w[:3, 3] = -R.T @ t
    return c2w


def near_far_from_poses(c2ws: Sequence[np.ndarray], object_id: int,
                        margin: float = 0.05) -> tuple:
    """near/far = camera distance -/+ diameter/2 with an extra margin
    (reference data_generatation-Blender.py:111-127)."""
    dists = [float(np.linalg.norm(np.asarray(m)[:3, 3])) for m in c2ws]
    radius_m = YCBV_DIAMETERS_MM[object_id] / 2000.0
    near = min(dists) - radius_m - margin
    far = max(dists) + radius_m + margin
    return max(near, 1e-3), far


def convert_bop_scene(bop_scene_dir: str, out_dir: str, object_id: int,
                      splits: Dict[str, float] = None,
                      rgb_subdir: str = "rgb") -> Dict[str, str]:
    """Convert one BOP scene directory (scene_camera.json + rgb/*.png) into
    transforms_{train,val,test}.json under out_dir.

    splits: fraction per split, default {'train': .8, 'val': .1, 'test': .1}
    (frames are assigned round-robin by index so all splits cover the full
    viewpoint range).
    """
    splits = splits or {"train": 0.8, "val": 0.1, "test": 0.1}
    with open(os.path.join(bop_scene_dir, "scene_camera.json")) as f:
        cams = json.load(f)

    frame_ids = sorted(cams.keys(), key=int)
    rgb_dir = os.path.join(bop_scene_dir, rgb_subdir)

    frames = []
    c2ws = []
    for fid in frame_ids:
        cam = cams[fid]
        c2w = w2c_to_c2w_gl(cam["cam_R_w2c"], cam["cam_t_w2c"])
        c2ws.append(c2w)
        K = np.asarray(cam["cam_K"], np.float64).reshape(3, 3)
        fname = f"{int(fid):06d}.png"
        frames.append({
            "file_path": os.path.abspath(os.path.join(rgb_dir, fname)),
            "transform_matrix": c2w.tolist(),
            "intrinsic_matrix": K.tolist(),
        })

    near, far = near_far_from_poses(c2ws, object_id)

    # round-robin split assignment
    names = list(splits.keys())
    weights = np.array([splits[n] for n in names])
    weights = weights / weights.sum()
    boundaries = np.cumsum(weights)
    split_frames: Dict[str, List] = {n: [] for n in names}
    for i, frame in enumerate(frames):
        r = (i % 10) / 10.0
        split = names[int(np.searchsorted(boundaries, r, side="right"))]
        split_frames[split].append(frame)

    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for split in ("train", "val", "test"):
        doc = {
            "camera_angle_x": 0.0,  # intrinsics are per-frame
            "near": near, "far": far,
            "frames": split_frames.get(split, []),
        }
        p = os.path.join(out_dir, f"transforms_{split}.json")
        with open(p, "w") as f:
            json.dump(doc, f, indent=1)
        paths[split] = p
    return paths


def write_traindata_info(out_path: str, H: int, W: int, K: np.ndarray,
                         near: float, far: float, sample_file: str = ""):
    """Emit the pipeline's nerf_traindata_info.json (consumed by
    data.blender.load_data_param)."""
    doc = {
        "near": near, "far": far, "H": H, "W": W,
        "frames": [{
            "file_path": sample_file,
            "transform_matrix": np.eye(4).tolist(),
            "intrinsic_matrix": np.asarray(K, np.float64).tolist(),
        }],
    }
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=2)
