"""The port's entry point (neuralsim_tpu_torch/cli.py) and its flag parser
(neuralsim_tpu_torch/config.py) against the JAX package's: parse_cli /
load_config give, field by field, the JAX config for the same argv and txt
config (unknown flags raise on both sides, a flag whose field the port
leaves out raises in the port naming it); the detector data loaded from
the reference's directory layout equal JAX's; cli.main runs one tiny
epoch on the CPU (with --device cpu from the command line too) and writes
the experiment record."""

import dataclasses
import json

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from neuralsim_tpu import cli as jcli
from neuralsim_tpu import config as jcfg
from neuralsim_tpu_torch import cli as tcli
from neuralsim_tpu_torch import config as tcfg
from neuralsim_tpu_torch.utils.checkpoint import save_nerf_tar_compatible
from tests.test_torch_driver import box_models, port_cfg

ARGVS = {
    "reference": ["--expname", "exp1", "--object_id", "2", "--psi_pose_cats_mode", "5",
                  "--test_distribution", "one_1", "--n_samples_K", "10",
                  "--opt_method", "Adam", "--gumble_T", "0.1"],
    "production": ["--production_render", "--n_samples_culled", "24",
                   "--n_importance_culled", "None", "--hit_budget=0.5"],
    "solvers": ["--ihvp_solver", "cg_normal", "--cg_iters", "4", "--lissa_scale", "-1",
                "--psi_mode", "gaussian", "--grad_mode", "rev", "--grad_hit_budget", "0",
                "--eval_stream_images", "16", "--grad_compute_dtype", "float32"],
    "flags": ["--no_batching", "--white_bkgd", "--half_res", "--render_only", "--perturb", "0",
              "--optimization", "0", "--pretrain", "1", "--pretrain_weight", "w.npz",
              "--N_rand", "2048", "--netchunk", "65536", "--no_reload", "--chunk", "512"],
}


def assert_same_config(port: tcfg.NeuralSimConfig, jax_cfg: jcfg.NeuralSimConfig):
    """Every field of the port's config equals the JAX config's."""
    for f in dataclasses.fields(port):
        mine, theirs = getattr(port, f.name), getattr(jax_cfg, f.name)
        if not dataclasses.is_dataclass(mine):
            assert mine == theirs, f.name
            continue
        for g in dataclasses.fields(mine):
            assert getattr(mine, g.name) == getattr(theirs, g.name), f"{f.name}.{g.name}"


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parse_cli_equals_jax(tmp_path, name):
    cfg_txt = tmp_path / "nerf_param.txt"
    cfg_txt.write_text("N_samples = 32\nN_importance = 96\nchunk = 1024 # comment\n"
                       "use_viewdirs = True\nlrate_decay = 250\nexpname = from_file\n")
    for argv in (ARGVS[name], ["--config", str(cfg_txt)] + ARGVS[name]):
        port, theirs = tcfg.parse_cli(argv), jcfg.parse_cli(argv)
        assert_same_config(port, theirs)
    assert port.render.n_samples == 32 and port.train.lrate_decay == 250


def test_load_config_and_flags_equal_jax(tmp_path):
    cfg_txt = tmp_path / "c.txt"
    cfg_txt.write_text("netdepth = 4\nnetwidth = 128\nmultires = 6\nexpname = a\n")
    assert_same_config(tcfg.load_config(str(cfg_txt), {"expname": "b", "lindisp": True}),
                       jcfg.load_config(str(cfg_txt), {"expname": "b", "lindisp": True}))
    assert tcfg.load_config().render == tcfg.RenderConfig()
    assert tcfg.config_from_flags({"production_render": True}).render == \
        tcfg.RenderConfig().production_mode()
    for raw in ("True", "no", "3", "2.5", "aabb", "None"):
        assert tcfg._coerce(raw) == jcfg._coerce(raw)


def test_unknown_and_left_out_flags_raise():
    with pytest.raises(KeyError, match="unknown flag: --not_a_flag"):
        tcfg.parse_cli(["--not_a_flag", "1"])
    with pytest.raises(KeyError, match="unknown flag: --not_a_flag"):
        jcfg.parse_cli(["--not_a_flag", "1"])
    # the JAX package takes it; the port has no such field and says so
    assert jcfg.parse_cli(["--grad_dynamic_start", "False"]).bilevel.grad_dynamic_start is False
    with pytest.raises(KeyError, match="--grad_dynamic_start"):
        tcfg.parse_cli(["--grad_dynamic_start", "False"])
    with pytest.raises(SystemExit):
        tcfg.parse_cli(["stray"])


def write_reference_layout(tmp_path):
    """A reference-shaped experiment directory: train_val_path_info with
    background class dirs and a val distribution, PNGs with one box each."""
    rng = np.random.RandomState(0)
    basedir = tmp_path / "logs"

    def dump(d, n=2):
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img = np.zeros((24, 24, 3), np.uint8)
            y, x = rng.randint(2, 10, 2)
            img[y:y + 10, x:x + 10] = rng.randint(100, 255, 3)
            imageio.imwrite(str(d / f"{i:06d}.png"), img)

    for cate in ("1", "2", "10"):
        dump(basedir / "D_train" / cate)
        dump(basedir / "D_val" / "one_1" / cate)
    path_info = {"dataset_name": "test",
                 "train_info": {c: f"D_train/{c}" for c in ("1", "2", "10")},
                 "test_info": {"one_1": {c: f"D_val/one_1/{c}" for c in ("1", "2", "10")}}}
    pi = tmp_path / "path_info.json"
    pi.write_text(json.dumps(path_info))
    return str(basedir), str(pi)


def test_load_detector_data_equals_jax(tmp_path):
    basedir, pi = write_reference_layout(tmp_path)
    cfg = port_cfg()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, basedir=basedir,
                                               train_val_path_info=pi, object_id="2"))
    from tests.test_torch_driver import jax_cfg

    val, cls, bg, bg_labels = tcli._load_detector_data(cfg, "cpu")
    jval, jcls, jbg, jbg_labels = jcli._load_detector_data(jax_cfg(cfg))
    assert cls == jcls == 1                          # sorted by (len, name): 1, 2, 10
    for g, w in zip(val, jval):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    assert val.gt_valid[:, 0].all() and len(val.images) == 6
    np.testing.assert_array_equal(bg, jbg)
    assert bg_labels == jbg_labels == [0, 0, 2, 2]
    # no path info: one empty val image, no backgrounds
    cfg0 = cfg.replace(data=dataclasses.replace(cfg.data, train_val_path_info="missing.json"))
    val0, cls0, bg0, _ = tcli._load_detector_data(cfg0, "cpu")
    jval0, *_ = jcli._load_detector_data(jax_cfg(cfg0))
    assert cls0 == 0 and bg0 is None
    for g, w in zip(val0, jval0):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def tiny_cli_cfg(tmp_path):
    """The driver tests' config writing to tmp_path, the box scene from a
    reference .tar written by save_nerf_tar_compatible."""
    tar = str(tmp_path / "box.tar")
    save_nerf_tar_compatible(tar, box_models())
    cfg = port_cfg(n_epochs=1, opt_lr=1e-2)
    return cfg.replace(data=dataclasses.replace(
        cfg.data, basedir=str(tmp_path / "logs"), datadir=str(tmp_path / "none"),
        expname="cli_e2e", ft_path=tar, train_val_path_info=str(tmp_path / "missing.json")))


def test_cli_main_runs_one_epoch_on_the_cpu(tmp_path):
    cfg = tiny_cli_cfg(tmp_path)
    result = tcli.main(cfg=cfg, device="cpu")
    assert result["psi"].shape == (8,) and len(result["history"]) == 1
    assert np.isfinite(result["history"][0]["psi_probs"]).all()
    out = tmp_path / "logs" / "cli_e2e"
    assert json.loads((out / "args.txt").read_text())["data"]["expname"] == "cli_e2e"
    lines = (out / "detectron_output" / "save_result.txt").read_text().splitlines()
    assert len(lines) == 2 and lines[0].startswith("epoch: 0{'AP'")


def test_cli_main_parses_argv_and_device(tmp_path, monkeypatch):
    """``--device cpu`` and the reference flags reach the renderer and the
    driver (the run itself stubbed); without a GPU and without --device
    the entry point raises."""
    from neuralsim_tpu_torch.bilevel import driver as tdriver

    seen = {}

    def fake_run(self):
        seen.update(device=self.device, cfg=self.cfg, models=self.nerf_models)
        return {"psi": torch.zeros(8), "history": []}

    monkeypatch.setattr(tdriver.BilevelDriver, "run", fake_run)
    tar = str(tmp_path / "box.tar")
    save_nerf_tar_compatible(tar, box_models())
    argv = ["--basedir", str(tmp_path / "logs"), "--expname", "x", "--ft_path", tar,
            "--netdepth", "4", "--netwidth", "32", "--netdepth_fine", "4",
            "--netwidth_fine", "32", "--n_samples_K", "2", "--device", "cpu"]
    tcli.main(argv)
    assert seen["device"] == torch.device("cpu")
    assert seen["cfg"].sampler.n_samples_k == 2 and seen["cfg"].data.expname == "x"
    want = box_models()["coarse"]
    for k, v in seen["models"]["coarse"].items():
        np.testing.assert_array_equal(v.numpy(), want[k])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(argv[:-2])
