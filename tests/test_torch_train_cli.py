"""The port's NeRF trainer command line (``neuralsim_tpu_torch/train_cli.py``)
and its LINEMOD loader (``data/blender.py:load_linemod_data``) against the
JAX package's, on the CPU: the loader bit-equal on a tiny directory
(half_res, testskip); both cases of ``tests/test_train_cli.py`` replayed
through the port; the spiral without imageio (PNG frames, said so); the
test-set render and a JAX npz checkpoint restored; and the numeric policy
of the card (TF32 off, deterministic cuDNN) that ``cli.main`` and
``train_cli.main`` set once their device is CUDA (the CUDA check
monkeypatched, so that it runs here)."""

import builtins
import dataclasses
import json

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

import neuralsim_tpu_torch
from neuralsim_tpu import train_cli as jtrain_cli
from neuralsim_tpu.data.blender import load_linemod_data as jload
from neuralsim_tpu_torch import cli as tcli
from neuralsim_tpu_torch import train_cli
from neuralsim_tpu_torch.data import load_linemod_data
from neuralsim_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from neuralsim_tpu_torch.utils.png import write_png


def write_scene(datadir, hw=16, n=(3, 2, 5), rgba=True, writer="imageio", seed=0):
    """A LINEMOD-layout dataset: n frames per split (train, val, test),
    hw x hw PNGs, absolute file_path, per-frame intrinsics, near/far."""
    datadir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    K = [[20.0, 0.0, hw / 2], [0.0, 20.0, hw / 2], [0.0, 0.0, 1.0]]
    for split, count in zip(("train", "val", "test"), n):
        frames = []
        for i in range(count):
            img = (rng.rand(hw, hw, 4 if rgba else 3) * 255).astype(np.uint8)
            path = datadir / f"{split}_{i}.png"
            (imageio.imwrite if writer == "imageio" else write_png)(str(path), img)
            c2w = np.eye(4)
            c2w[2, 3] = 1.2 + 0.1 * i
            c2w[0, 3] = 0.05 * i
            frames.append({"file_path": str(path), "transform_matrix": c2w.tolist(),
                           "intrinsic_matrix": K})
        (datadir / f"transforms_{split}.json").write_text(json.dumps(
            {"frames": frames, "near": 1.5 - 0.1 * len(split), "far": 2.5 + 0.1 * count}))
    return datadir


@pytest.mark.parametrize("half_res, testskip", [(False, 1), (True, 2), (True, 0)])
@pytest.mark.parametrize("writer", ["imageio", "write_png"])
def test_load_linemod_data_equals_jax(tmp_path, half_res, testskip, writer):
    d = write_scene(tmp_path / "scene", writer=writer)
    got = load_linemod_data(str(d), half_res, testskip, n_render_poses=8)
    want = jload(str(d), half_res, testskip, n_render_poses=8)
    for name in ("images", "poses"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.i_split, want.i_split):
        np.testing.assert_array_equal(a, b)
    assert got.camera[:3] == want.camera[:3] and got.camera[4:] == want.camera[4:]
    np.testing.assert_array_equal(got.camera.K, want.camera.K)
    assert got.render_poses.dtype == np.float32 and got.render_poses.shape == (8, 4, 4)
    # the spiral's sines and cosines in float32 by ATen and by XLA: equal
    # here, an ulp apart for a few entries of the default 40 poses
    np.testing.assert_allclose(got.render_poses, want.render_poses, rtol=0, atol=1e-7)
    assert len(got.i_split[2]) == (5 if testskip in (0, 1) else 3)


def test_area_resize_half_is_mean_pooling():
    from neuralsim_tpu.data.blender import _area_resize_half as jresize
    from neuralsim_tpu_torch.data.blender import _area_resize_half

    img = np.random.RandomState(1).rand(7, 9, 4).astype(np.float32)
    np.testing.assert_array_equal(_area_resize_half(img, 2), jresize(img, 2))
    np.testing.assert_allclose(_area_resize_half(img, 2)[0, 0], img[:2, :2].mean((0, 1)),
                               rtol=1e-6)


# ------------------------------------- replay of tests/test_train_cli.py --

TINY_FLAGS = [
    "--netdepth", "2", "--netwidth", "16",
    "--netdepth_fine", "2", "--netwidth_fine", "16",
    "--multires", "2", "--multires_views", "1",
    "--N_samples", "4", "--N_importance", "4",
    "--N_rand", "16", "--chunk", "256", "--device", "cpu",
]


@pytest.fixture()
def tiny_scene(tmp_path):
    """Blender-layout dataset: 2 frames per split, 16x16 RGBA PNGs."""
    return write_scene(tmp_path / "scene", n=(2, 2, 2))


def test_periodic_artifacts_in_loop(tiny_scene, tmp_path):
    expdir = tmp_path / "logs" / "run"
    argv = TINY_FLAGS + [
        "--datadir", str(tiny_scene),
        "--basedir", str(tmp_path / "logs"), "--expname", "run",
        "--n_iters", "4", "--i_weights", "2", "--i_video", "4",
        "--i_testset", "4", "--i_print", "0",
    ]
    state = train_cli.main(argv)
    assert int(state.step) == 4
    # i_weights=2 over 4 iters -> tar dumps at 2 and 4 (in-loop, not only at the end)
    assert (expdir / "000002.tar").exists()
    assert (expdir / "000004.tar").exists()
    # i_video/i_testset=4 -> one in-loop spiral video + testset dir
    assert any(p.name.startswith("spiral_000004") for p in expdir.iterdir())
    assert (expdir / "testset_000004").is_dir()
    assert (expdir / "testset_000004" / "000.png").exists()


def test_render_only_short_circuit(tiny_scene, tmp_path):
    base = [
        "--datadir", str(tiny_scene),
        "--basedir", str(tmp_path / "logs"), "--expname", "run",
    ]
    # no checkpoint yet -> explicit failure, not silent training
    with pytest.raises(SystemExit):
        train_cli.main(TINY_FLAGS + base + ["--render_only"])

    # train 2 iters to produce a checkpoint, then render_only from it
    train_cli.main(TINY_FLAGS + base + ["--n_iters", "2", "--i_weights", "2",
                                        "--i_video", "0", "--i_testset", "0", "--i_print", "0"])
    expdir = tmp_path / "logs" / "run"
    out = train_cli.main(TINY_FLAGS + base + ["--render_only"])
    assert out is None  # short-circuit: no training state returned
    ro = [p for p in expdir.iterdir() if p.name.startswith("renderonly_path_")]
    assert len(ro) == 1 and any(ro[0].iterdir())

    train_cli.main(TINY_FLAGS + base + ["--render_only", "--render_test"])
    rt = [p for p in expdir.iterdir() if p.name.startswith("renderonly_test_")]
    assert len(rt) == 1 and (rt[0] / "000.png").exists()


# ------------------------------------------------------------- the parts --

def _tiny(tmp_path):
    from neuralsim_tpu_torch.config import parse_cli

    d = write_scene(tmp_path / "scene", n=(2, 1, 2))
    cfg = parse_cli(TINY_FLAGS[:-2] + ["--datadir", str(d)])
    ds = load_linemod_data(str(d), False, 1, n_render_poses=3)
    return cfg, ds


def test_spiral_without_imageio_writes_png_frames_and_says_so(tmp_path, monkeypatch, capsys):
    """Where imageio does not import (the card's machine), the spiral is a
    directory of PNG frames; the result and the printed line say that no
    video was written. With imageio it is a video file, as in JAX."""
    from neuralsim_tpu_torch.models.nerf import init_nerf_pipeline_params
    from neuralsim_tpu_torch.utils.png import read_png

    cfg, ds = _tiny(tmp_path)
    models = init_nerf_pipeline_params(cfg.net, cfg.render.n_importance,
                                       torch.Generator().manual_seed(0))
    rc = dataclasses.replace(cfg.render, near=ds.camera.near, far=ds.camera.far)
    real_import = builtins.__import__

    def no_imageio(name, *args, **kw):
        if name.startswith("imageio"):
            raise ImportError("No module named 'imageio'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_imageio)
    spiral = train_cli.render_spiral_video(models, ds, cfg.net, rc,
                                           str(tmp_path / "e" / "spiral_000007.mp4"),
                                           device="cpu")
    monkeypatch.undo()
    assert spiral.video is False and spiral.path.endswith("spiral_000007_frames")
    frames = sorted((tmp_path / "e" / "spiral_000007_frames").iterdir())
    assert [f.name for f in frames] == ["000.png", "001.png", "002.png"]
    assert read_png(str(frames[0])).shape == (16, 16, 3)
    assert "no video written" in capsys.readouterr().out
    assert not (tmp_path / "e" / "spiral_000007.mp4").exists()
    with_video = train_cli.render_spiral_video(models, ds, cfg.net, rc,
                                               str(tmp_path / "v" / "s.mp4"), device="cpu")
    assert with_video.video and with_video.path.rsplit(".", 1)[1] in ("mp4", "gif")


def test_render_testset_equals_jax(tmp_path):
    """The same params render the same test set: PSNR to 1e-4 dB and the
    same PNGs to one grey level."""
    from neuralsim_tpu import config as jcfg
    from neuralsim_tpu.models.nerf import init_nerf_pipeline_params as jinit

    cfg, ds = _tiny(tmp_path)
    jnet = jcfg.NeRFNetConfig(**dataclasses.asdict(cfg.net))
    rc = dataclasses.replace(cfg.render, near=ds.camera.near, far=ds.camera.far)
    jrc = jcfg.RenderConfig(**dataclasses.asdict(rc))
    jmodels = jax.tree_util.tree_map(np.asarray,
                                     jinit(jax.random.PRNGKey(1), jnet, jrc.n_importance))
    psnr = train_cli.render_testset(params_from_numpy(jmodels, "cpu"), ds, cfg.net, rc,
                                    str(tmp_path / "port"), device="cpu")
    jds = jload(str(tmp_path / "scene"), False, 1, n_render_poses=3)
    jpsnr = jtrain_cli.render_testset(jmodels, jds, jnet, jrc, str(tmp_path / "jax"))
    assert np.isfinite(psnr) and abs(psnr - jpsnr) < 1e-4
    for i in range(2):
        a = imageio.imread(tmp_path / "port" / f"{i:03d}.png").astype(int)
        b = imageio.imread(tmp_path / "jax" / f"{i:03d}.png").astype(int)
        assert np.abs(a - b).max() <= 1


def test_restore_params_reads_a_jax_npz_checkpoint(tmp_path):
    """The latest checkpoint under {expdir}/checkpoints written by the JAX
    package's manager (its npz layout) restores into the port; an explicit
    ft_path (.tar) wins."""
    from neuralsim_tpu.utils.checkpoint import CheckpointManager as JManager
    from neuralsim_tpu_torch.models.nerf import init_nerf_pipeline_params
    from neuralsim_tpu_torch.utils.checkpoint import save_nerf_tar_compatible

    cfg, _ = _tiny(tmp_path)
    want = params_to_numpy(init_nerf_pipeline_params(cfg.net, cfg.render.n_importance,
                                                     torch.Generator().manual_seed(5)))
    expdir = tmp_path / "exp"
    JManager(str(expdir / "checkpoints"), use_orbax=False).save(7, {"params": want})
    models, step = train_cli.restore_params(cfg, str(expdir), "cpu")
    assert step == 7
    for name in want:
        for k, v in want[name].items():
            np.testing.assert_array_equal(models[name][k].numpy(), v)
    tar = str(tmp_path / "x.tar")
    save_nerf_tar_compatible(tar, {"coarse": want["coarse"]}, global_step=3)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, ft_path=tar))
    models, step = train_cli.restore_params(cfg, str(expdir), "cpu")
    assert step == 3 and set(models) == {"coarse"}
    assert train_cli.restore_params(cfg.replace(data=dataclasses.replace(
        cfg.data, ft_path=None)), str(tmp_path / "empty"), "cpu") == (None, 0)


# ------------------------------------------------------ numeric policy --

@pytest.fixture
def card_policy_off(monkeypatch):
    """torch's switches set the other way (TF32 on, benchmarked cuDNN), and
    the CUDA check answering yes; every switch restored after the test."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    monkeypatch.setattr(neuralsim_tpu_torch, "on_card", lambda device: True)


def _assert_card_policy():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.deterministic is True
    assert torch.backends.cudnn.benchmark is False


def test_set_card_numerics(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    neuralsim_tpu_torch.set_card_numerics(torch.device("cpu"))   # another device: nothing
    assert torch.backends.cudnn.allow_tf32 is True
    assert torch.backends.cudnn.deterministic is False
    assert neuralsim_tpu_torch.on_card("cuda") and neuralsim_tpu_torch.on_card("cuda:1")
    assert not neuralsim_tpu_torch.on_card("cpu")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    neuralsim_tpu_torch.set_card_numerics(torch.device("cuda"))
    _assert_card_policy()


def test_train_cli_main_sets_the_card_policy(card_policy_off, tiny_scene, tmp_path):
    train_cli.main(TINY_FLAGS + ["--datadir", str(tiny_scene), "--basedir",
                                 str(tmp_path / "logs"), "--n_iters", "1", "--i_print", "0"])
    _assert_card_policy()


def test_cli_main_sets_the_card_policy(card_policy_off, tmp_path, monkeypatch):
    from neuralsim_tpu_torch.bilevel import driver as tdriver
    from neuralsim_tpu_torch.utils.checkpoint import save_nerf_tar_compatible
    from tests.test_torch_driver import box_models

    monkeypatch.setattr(tdriver.BilevelDriver, "run",
                        lambda self: {"psi": torch.zeros(8), "history": []})
    tar = str(tmp_path / "box.tar")
    save_nerf_tar_compatible(tar, box_models())
    tcli.main(["--basedir", str(tmp_path / "logs"), "--expname", "x", "--ft_path", tar,
               "--netdepth", "4", "--netwidth", "32", "--netdepth_fine", "4",
               "--netwidth_fine", "32", "--n_samples_K", "2", "--device", "cpu"])
    _assert_card_policy()
