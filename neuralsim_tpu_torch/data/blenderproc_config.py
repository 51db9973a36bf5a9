"""BlenderProc camera-sampling scene config generator (the port's own copy of
``neuralsim_tpu/data/blenderproc_config.py``, which uses no framework).

The reference ships a hand-written BlenderProc YAML
(``data/BlenderProc/examples/camera_sampling/config.yaml``: BopLoader for a
YCB-V object with mm2m, one white point light, a shell camera sampler at
radius ~1 with elevation 0-45 deg looking at the POI, 300 RGBA renders at
400^2, BopWriter). This module generates the equivalent config
programmatically so dataset-generation recipes are parameterized instead of
copy-edited.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class SceneRecipe:
    object_id: int = 2
    bop_dataset: str = "ycbv"
    n_poses: int = 300
    resolution: int = 400
    radius_min: float = 1.0
    radius_max: float = 1.01
    elevation_min_deg: float = 0.0
    elevation_max_deg: float = 45.0
    inplane_rot_deg: float = 45.0
    light_energy: float = 2000.0
    transparent_background: bool = True


def blenderproc_config(recipe: SceneRecipe, bop_path: str = "<args:0>",
                       output_dir: str = "<args:1>") -> dict:
    """Build the module list as a python dict; dump with to_yaml()."""
    return {
        "version": 3,
        "setup": {"blender_install_path": "/home_local/<env:USER>/blender/",
                  "pip": ["h5py", "scipy"]},
        "modules": [
            {"module": "main.Initializer",
             "config": {"global": {"output_dir": output_dir}}},
            {"module": "loader.BopLoader",
             "config": {
                 "bop_dataset_path": f"{bop_path}/{recipe.bop_dataset}",
                 "mm2m": True,
                 "split": "val",
                 "obj_ids": [recipe.object_id],
                 "model_type": "",
             }},
            {"module": "lighting.LightLoader",
             "config": {"lights": [{
                 "type": "POINT",
                 "location": [5, -5, 5],
                 "energy": recipe.light_energy,
                 "color": [1.0, 1.0, 1.0],
             }]}},
            {"module": "camera.CameraSampler",
             "config": {"cam_poses": [{
                 "number_of_samples": recipe.n_poses,
                 "location": {
                     "provider": "sampler.Shell",
                     "center": [0, 0, 0],
                     "radius_min": recipe.radius_min,
                     "radius_max": recipe.radius_max,
                     "elevation_min": recipe.elevation_min_deg,
                     "elevation_max": recipe.elevation_max_deg,
                 },
                 "rotation": {
                     "format": "look_at",
                     "value": {"provider": "getter.POI"},
                     "inplane_rot": {
                         "provider": "sampler.Value",
                         "type": "float",
                         "min": -recipe.inplane_rot_deg * 3.14159 / 180.0,
                         "max": recipe.inplane_rot_deg * 3.14159 / 180.0,
                     },
                 },
             }]}},
            {"module": "renderer.RgbRenderer",
             "config": {
                 "output_key": "colors",
                 "samples": 350,
                 "transparent_background": recipe.transparent_background,
                 "image_width": recipe.resolution,
                 "image_height": recipe.resolution,
             }},
            {"module": "writer.BopWriter",
             "config": {
                 "dataset": recipe.bop_dataset,
                 "append_to_existing_output": True,
             }},
        ],
    }


def to_yaml(config: dict) -> str:
    """Minimal YAML emitter (no external dependency) — sufficient for the
    nested dict/list/scalars structure BlenderProc consumes."""

    def emit(node, indent=0):
        pad = "  " * indent
        lines = []
        if isinstance(node, dict):
            for key, val in node.items():
                if isinstance(val, (dict, list)) and val:
                    lines.append(f"{pad}{key}:")
                    lines.extend(emit(val, indent + 1))
                else:
                    lines.append(f"{pad}{key}: {_scalar(val)}")
        elif isinstance(node, list):
            for item in node:
                if isinstance(item, (dict, list)) and item:
                    sub = emit(item, indent + 1)
                    first = sub[0].lstrip()
                    lines.append(f"{pad}- {first}")
                    lines.extend(sub[1:])
                else:
                    lines.append(f"{pad}- {_scalar(item)}")
        return lines

    def _scalar(v):
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, str):
            return json.dumps(v) if any(c in v for c in ":#{}") else v
        if isinstance(v, (list, dict)) and not v:
            return json.dumps(v)
        return repr(v) if isinstance(v, float) else str(v)

    return "\n".join(emit(config)) + "\n"


def write_config(path: str, recipe: Optional[SceneRecipe] = None):
    cfg = blenderproc_config(recipe or SceneRecipe())
    with open(path, "w") as f:
        f.write(to_yaml(cfg))
    return path
