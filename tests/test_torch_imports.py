"""Guard: the port and its chip scripts import neither JAX nor the JAX
package, its kernel sources never ask for fast-math sines, and its
subpackages export the names of the JAX ones that are ported."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "neuralsim_tpu_torch"
SOURCES = (sorted(PORT.rglob("*.py")) + sorted(ROOT.glob("chip_*.py"))
           + [ROOT / "png_timing.py"])
KERNELS = sorted(PORT.rglob("*.cu")) + sorted(PORT.rglob("*.cuh"))


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "neuralsim_tpu", "flax", "optax")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value


def test_port_files_exist():
    assert (PORT / "__init__.py").exists() and (ROOT / "chip_smoke.py").exists()
    assert KERNELS, "the port's CUDA sources are missing"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if _banned(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_banned_names():
    assert _banned("neuralsim_tpu.ops.render") and _banned("jax.numpy")
    assert not _banned("neuralsim_tpu_torch.ops.render")


def test_kernels_use_accurate_sines():
    for path in KERNELS + [PORT / "kernels" / "build.py"]:
        text = path.read_text()
        assert "use_fast_math" not in text, path
        assert "__sinf" not in text and "__cosf" not in text, path


SUBPACKAGES = ("ops", "sampler", "models", "data", "bilevel", "hypergrad", "detector", "utils")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackages_export_the_ported_names(sub):
    """Each subpackage's __all__ names import, each is a name of the JAX
    counterpart's __all__, and every name of that list that the port
    defines anywhere is exported (what is left out is not ported yet)."""
    import importlib

    port = importlib.import_module(f"neuralsim_tpu_torch.{sub}")
    ref = importlib.import_module(f"neuralsim_tpu.{sub}")
    assert port.__all__ and len(set(port.__all__)) == len(port.__all__)
    assert set(port.__all__) <= set(ref.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    defined = "\n".join(p.read_text() for p in PORT.rglob("*.py"))
    for name in set(ref.__all__) - set(port.__all__):
        assert f"def {name}(" not in defined and f"class {name}(" not in defined, name


def test_from_imports_of_the_subpackages():
    from neuralsim_tpu_torch.bilevel import psi_init
    from neuralsim_tpu_torch.bilevel.driver import BilevelDriver, EpochDraws, ValData
    from neuralsim_tpu_torch.cli import main
    from neuralsim_tpu_torch.config import parse_cli
    from neuralsim_tpu_torch.hypergrad import inverse_hvp, mixed_grad_wrt_images
    from neuralsim_tpu_torch.hypergrad.unrolled import unrolled_grad_images
    from neuralsim_tpu_torch.utils import ResultLog, phase_timer
    from neuralsim_tpu_torch.utils.checkpoint import CheckpointManager
    from neuralsim_tpu_torch.data import load_nerf_checkpoint
    from neuralsim_tpu_torch.detector import coco_map, inner_train
    from neuralsim_tpu_torch.models import nerf_apply
    from neuralsim_tpu_torch.ops import get_rays, render_poses
    from neuralsim_tpu_torch.ops import render as render_module
    from neuralsim_tpu_torch.sampler import poses_from_noise

    assert render_poses is render_module.render_poses
    assert all(callable(f) for f in (psi_init, load_nerf_checkpoint, nerf_apply, get_rays,
                                     poses_from_noise, coco_map, inner_train, BilevelDriver,
                                     main, parse_cli, inverse_hvp, mixed_grad_wrt_images,
                                     unrolled_grad_images, ResultLog, phase_timer,
                                     CheckpointManager))
    assert EpochDraws._fields == ("noise", "batch_idx", "hvp_idx")
    assert ValData._fields == ("images", "gt_boxes", "gt_labels", "gt_valid")
    with pytest.raises(AttributeError):
        import neuralsim_tpu_torch.ops as ops

        ops.not_a_name


def test_from_imports_of_the_trainer_and_tools():
    from neuralsim_tpu_torch import on_card, set_card_numerics
    from neuralsim_tpu_torch.data import load_linemod_data
    from neuralsim_tpu_torch.data.blender import LinemodDataset
    from neuralsim_tpu_torch.data.blenderproc_config import SceneRecipe, blenderproc_config
    from neuralsim_tpu_torch.data.bop_convert import convert_bop_scene, write_traindata_info
    from neuralsim_tpu_torch.ops.render import img2mse, mse2psnr
    from neuralsim_tpu_torch.sampler.diagnostics import (
        plot_temperature_sweep,
        sample_histogram,
        temperature_sweep,
    )
    from neuralsim_tpu_torch.train_cli import main, render_spiral_video, render_testset
    from neuralsim_tpu_torch.train_nerf import (
        RayPool,
        StepDraws,
        TrainState,
        make_optimizer,
        train_nerf,
        train_state_from_jax,
        train_step,
    )
    from neuralsim_tpu_torch.utils.png import read_png, write_png

    assert all(callable(f) for f in (
        on_card, set_card_numerics, load_linemod_data, blenderproc_config, convert_bop_scene,
        write_traindata_info, img2mse, mse2psnr, plot_temperature_sweep, sample_histogram,
        temperature_sweep, main, render_spiral_video, render_testset, make_optimizer,
        train_nerf, train_state_from_jax, train_step, read_png, write_png))
    assert TrainState._fields == ("params", "opt_state", "step")
    assert RayPool._fields == ("rays_o", "rays_d", "rgb")
    assert StepDraws._fields == ("image", "pixels", "perm", "uniforms")
    assert LinemodDataset._fields == ("images", "poses", "render_poses", "camera", "i_split")
    assert SceneRecipe(object_id=2).object_id == 2


def test_imageio_only_for_the_optional_video():
    """The card's machine has no imageio: the port reads and writes PNGs
    with utils/png.py, and imports imageio in one place only, the spiral
    video of train_cli, which writes PNG frames and says so without it."""
    users = {str(p.relative_to(ROOT)) for p in SOURCES
             if any(m.split(".")[0] == "imageio" for m in _imports(p))}
    assert users == {"neuralsim_tpu_torch/train_cli.py"}
    text = (PORT / "train_cli.py").read_text()
    assert "except ImportError:" in text
