"""The port's copies of the framework-free tools against the JAX package:
the BOP -> NeRF converter (every case of ``tests/test_bop_convert.py``
replayed on the port's functions, and the same files written by both), the
BlenderProc config (``test_distributed.py::test_blenderproc_config_roundtrip``
replayed) and the sampler diagnostics
(``test_dataset_extras.py::test_sampler_diagnostics_tracks_target``
replayed)."""

import inspect
import json

import numpy as np
import pytest
import torch

import neuralsim_tpu.data.blender as jblender
import tests.test_bop_convert as bop_case
from neuralsim_tpu.data import bop_convert as jbop
from neuralsim_tpu_torch.data import blender as tblender
from neuralsim_tpu_torch.data import blenderproc_config as tbp
from neuralsim_tpu_torch.data import bop_convert as tbop
from neuralsim_tpu_torch.sampler import diagnostics

BOP_NAMES = ("convert_bop_scene", "near_far_from_poses", "w2c_to_c2w_gl", "write_traindata_info")


@pytest.fixture
def port_bop(monkeypatch):
    """The case module's converter names (and the camera loader that its
    last case imports) pointed at the port's."""
    for name in BOP_NAMES:
        monkeypatch.setattr(bop_case, name, getattr(tbop, name))
    monkeypatch.setattr(jblender, "load_data_param", tblender.load_data_param)


@pytest.mark.parametrize("case", ["test_w2c_inversion_roundtrip", "test_near_far_covers_object",
                                  "test_convert_bop_scene", "test_write_traindata_info"])
def test_bop_convert_cases(port_bop, case, tmp_path, rng):
    fn = getattr(bop_case, case)
    fixtures = {"tmp_path": tmp_path, "rng": rng}
    fn(**{name: fixtures[name] for name in inspect.signature(fn).parameters})


def test_bop_convert_writes_what_jax_writes(tmp_path):
    """The same BOP scene converted by both packages: the same files."""
    rng = np.random.RandomState(4)
    scene = tmp_path / "000000"
    (scene / "rgb").mkdir(parents=True)
    cams = {}
    for i in range(7):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        cams[str(i)] = {"cam_K": [1066.0, 0, 320.0, 0, 1067.0, 240.0, 0, 0, 1],
                        "cam_R_w2c": q.reshape(-1).tolist(),
                        "cam_t_w2c": (rng.randn(3) * 100 + [0, 0, 1000]).tolist()}
    (scene / "scene_camera.json").write_text(json.dumps(cams))
    got = tbop.convert_bop_scene(str(scene), str(tmp_path / "port"), object_id=5)
    want = jbop.convert_bop_scene(str(scene), str(tmp_path / "jax"), object_id=5)
    assert set(got) == set(want)
    for split in got:
        with open(got[split]) as a, open(want[split]) as b:
            assert json.load(a) == json.load(b)
    K = np.array([[1333.33, 0, 195.4], [0, 1334.2, 200.6], [0, 0, 1]])
    tbop.write_traindata_info(str(tmp_path / "a.json"), 400, 400, K, 0.81, 1.43)
    jbop.write_traindata_info(str(tmp_path / "b.json"), 400, 400, K, 0.81, 1.43)
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    assert tbop.YCBV_DIAMETERS_MM == jbop.YCBV_DIAMETERS_MM
    assert tbop.YCBV_NAMES == jbop.YCBV_NAMES


def test_blenderproc_config_roundtrip(tmp_path):
    cfg = tbp.blenderproc_config(tbp.SceneRecipe(object_id=2, n_poses=300))
    modules = {m["module"] for m in cfg["modules"]}
    assert {"loader.BopLoader", "camera.CameraSampler", "renderer.RgbRenderer",
            "writer.BopWriter", "lighting.LightLoader"} <= modules
    sampler = next(m for m in cfg["modules"] if m["module"] == "camera.CameraSampler")
    pose_cfg = sampler["config"]["cam_poses"][0]
    assert pose_cfg["number_of_samples"] == 300
    assert pose_cfg["location"]["radius_max"] == 1.01

    text = tbp.to_yaml(cfg)
    assert "BopLoader" in text and "number_of_samples: 300" in text
    tbp.write_config(str(tmp_path / "config.yaml"))
    assert (tmp_path / "config.yaml").exists()


def test_blenderproc_config_equals_jax(tmp_path):
    from neuralsim_tpu.data import blenderproc_config as jbp

    recipe = dict(object_id=7, n_poses=12)
    assert tbp.to_yaml(tbp.blenderproc_config(tbp.SceneRecipe(**recipe))) == \
        jbp.to_yaml(jbp.blenderproc_config(jbp.SceneRecipe(**recipe)))
    tbp.write_config(str(tmp_path / "a.yaml"))
    jbp.write_config(str(tmp_path / "b.yaml"))
    assert (tmp_path / "a.yaml").read_text() == (tmp_path / "b.yaml").read_text()


def test_sampler_diagnostics_tracks_target():
    probs = np.array([0.0, 0.3, 0.0, 0.0, 0.0, 0.0, 0.7, 0.0], np.float32)
    sweep = diagnostics.temperature_sweep(probs, temperatures=(0.01, 5.0), n_samples=2000,
                                          device="cpu")
    lo, hi = sweep[0.01], sweep[5.0]
    # low temperature follows the target
    assert abs(lo[1] - 0.3) < 0.06 and abs(lo[6] - 0.7) < 0.06
    # high temperature collapses the soft expectation toward the MEAN of the
    # bin centers (~180 deg, bins 3-4), losing the true modes
    assert hi[3] + hi[4] > 0.7
    assert hi[1] + hi[6] < 0.2


def test_sample_histogram_is_a_distribution_and_repeats():
    probs = np.full(8, 1 / 8, np.float32)
    a = diagnostics.sample_histogram(probs, 0.1, 500, torch.Generator().manual_seed(3),
                                     device="cpu")
    b = diagnostics.sample_histogram(probs, 0.1, 500, torch.Generator().manual_seed(3),
                                     device="cpu")
    assert a.shape == (8,) and abs(a.sum() - 1.0) < 1e-12 and (a >= 0).all()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("temperature", [0.01, 0.1, 5.0])
def test_sample_histogram_equals_jax_on_its_draws(temperature):
    """The JAX sample_histogram's own Gumbel and in-bin uniform draws
    (its key split as at JAX diagnostics.py:22-29) fed to the port: the
    same histogram, bin for bin."""
    import jax

    from neuralsim_tpu.sampler import diagnostics as jdiag
    from neuralsim_tpu.sampler.gumbel import gumbel_noise as jgumbel_noise

    probs = np.array([0.05, 0.3, 0.0, 0.1, 0.0, 0.05, 0.5, 0.0], np.float32)
    n, key = 3000, jax.random.PRNGKey(11)
    kg, ku = jax.random.split(key)
    gumbel = np.array(jgumbel_noise(kg, (n, 8)))
    uniform = np.array(jax.random.uniform(ku, (n,)))
    want = jdiag.sample_histogram(probs, temperature, n, key)
    got = diagnostics.sample_histogram(probs, temperature, n, device="cpu", gumbel=gumbel,
                                       uniform=uniform)
    np.testing.assert_array_equal(got, want)


def test_sample_histogram_runs_on_the_card_by_default(monkeypatch):
    """With no device given it runs on cuda, and without one it raises
    rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        diagnostics.sample_histogram(np.full(8, 1 / 8, np.float32), 0.1, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        diagnostics.temperature_sweep(np.full(8, 1 / 8, np.float32), n_samples=10)


def test_plot_temperature_sweep(tmp_path, monkeypatch):
    """A figure where matplotlib imports, None where it does not (JAX
    diagnostics.py:49-69)."""
    import builtins

    probs = [0.1, 0.2, 0.3, 0.4, 0.0, 0.0, 0.0, 0.0]
    out = diagnostics.plot_temperature_sweep(probs, str(tmp_path / "g.png"),
                                             temperatures=(0.1, 5.0), n_samples=50,
                                             device="cpu")
    assert out == str(tmp_path / "g.png") and (tmp_path / "g.png").exists()
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name.startswith("matplotlib"):
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    assert diagnostics.plot_temperature_sweep(probs, str(tmp_path / "h.png")) is None
