"""The port's utils (neuralsim_tpu_torch/utils/) against the JAX
package's: the save_result lines and files byte for byte, the phase timer,
the NaN scope, the args snapshot, the NeRF .tar export, and the
PNG writer against ``to8b``."""

import json

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from neuralsim_tpu.utils import checkpoint as jckpt
from neuralsim_tpu.utils import logging as jlog
from neuralsim_tpu_torch.config import NeRFNetConfig, NeuralSimConfig
from neuralsim_tpu_torch.models.convert import load_nerf_checkpoint
from neuralsim_tpu_torch.models.nerf import init_nerf_pipeline_params
from neuralsim_tpu_torch.ops.render import to8b
from neuralsim_tpu_torch.utils import checkpoint as tckpt
from neuralsim_tpu_torch.utils import logging as tlog
from neuralsim_tpu_torch.utils.png import write_png
from neuralsim_tpu_torch.utils.profiling import (
    PhaseTimes,
    debug_nans,
    phase_timer,
)

MAP_RESULT = {"AP": 12.345678901234, "AP50": 50.0, "AP75": float("nan"), "APs": 0.0,
              "APm": float("nan"), "APl": 1e-9,
              "AP-per-class": {"0": 3.25, "1": float("nan")}}


def write_both(tmp_path, module, psi_soft):
    log = module.ResultLog(str(tmp_path / module.__name__))
    log.append(0, MAP_RESULT, text=module.map_result_str(MAP_RESULT))
    log.append(0, {"psi_softmax_T": psi_soft}, text=module.torch_tensor_str(psi_soft))
    log.append(3, {"grad_psi_nonfinite": True}, text="epoch 3: nonfinite grad_psi dropped")
    log.append(4, {"AP": np.float32(1.5), "psi": np.arange(3.0)})
    return log


@pytest.mark.parametrize("psi", [np.full(8, 0.125), np.array([0.9, 1e-6, 0.04, 0.03, 0.02,
                                                                0.005, 0.004, 0.001]),
                                 np.array([157.5, 30.0])], ids=["uniform", "peaked", "gaussian"])
def test_result_log_bytes_equal_jax(tmp_path, psi):
    psi = psi.astype(np.float32)
    mine = write_both(tmp_path, tlog, psi)
    theirs = write_both(tmp_path, jlog, psi)
    with open(mine.txt_path, "rb") as a, open(theirs.txt_path, "rb") as b:
        assert a.read() == b.read()
    with open(mine.jsonl_path) as a, open(theirs.jsonl_path) as b:
        for x, y in zip(a, b):
            x, y = json.loads(x), json.loads(y)
            assert x.pop("time") > 0 and y.pop("time") > 0
            assert json.dumps(x) == json.dumps(y)
    # tensors give the same line as arrays
    assert tlog.torch_tensor_str(torch.from_numpy(psi)) == jlog.torch_tensor_str(psi)


def test_phase_timer_counts_and_report():
    phases = PhaseTimes()
    for name in ("render", "render", "inner_train"):
        with phase_timer(name, phases, device="cpu"):
            torch.ones(4).sum()
    rep = phases.report()
    assert rep["render"]["count"] == 2 and rep["inner_train"]["count"] == 1
    assert rep["render"]["total_s"] >= 0
    assert rep["render"]["mean_s"] == pytest.approx(rep["render"]["total_s"] / 2)
    # a phase that raises is not counted
    with pytest.raises(ValueError):
        with phase_timer("fails", phases):
            raise ValueError
    assert "fails" not in phases.report()


def test_phase_timer_opens_a_profiler_range():
    from torch.profiler import ProfilerActivity, profile

    phases = PhaseTimes()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with phase_timer("grad_E", phases):
            torch.ones(8).exp()
    assert "grad_E" in {e.key for e in prof.key_averages()}


def test_debug_nans():
    with debug_nans(False):
        pass
    x = torch.tensor([-1.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="nan"):
        with debug_nans(True):
            torch.sqrt(x).sum().backward()


def test_save_args_snapshot(tmp_path):
    cfg_txt = tmp_path / "cfg.txt"
    cfg_txt.write_text("N_samples = 32\n")
    tlog.save_args_snapshot(str(tmp_path / "out"), NeuralSimConfig(), str(cfg_txt))
    data = json.loads((tmp_path / "out" / "args.txt").read_text())
    assert data["render"]["n_samples"] == 64 and data["detector"]["eval_stream_images"] == 0
    assert (tmp_path / "out" / "config.txt").read_text() == "N_samples = 32\n"


def test_nerf_tar_export_equals_jax(tmp_path):
    """save_nerf_tar_compatible writes the JAX package's state dicts, and
    the port's loader reads its params back exactly."""
    net = NeRFNetConfig(netdepth=2, netwidth=16, netdepth_fine=2, netwidth_fine=16, skips=(1,))
    models = init_nerf_pipeline_params(net, 8, torch.Generator().manual_seed(0))
    tckpt.save_nerf_tar_compatible(str(tmp_path / "a.tar"), models, global_step=7)
    jckpt.save_nerf_tar_compatible(
        str(tmp_path / "b.tar"),
        {m: {k: v.numpy() for k, v in p.items()} for m, p in models.items()}, global_step=7)
    a = torch.load(tmp_path / "a.tar", weights_only=True)
    b = torch.load(tmp_path / "b.tar", weights_only=True)
    assert a.keys() == b.keys() and a["global_step"] == 7
    for sd in ("network_fn_state_dict", "network_fine_state_dict"):
        assert a[sd].keys() == b[sd].keys()
        for k in a[sd]:
            assert torch.equal(a[sd][k], b[sd][k]), k
    back, step = load_nerf_checkpoint(str(tmp_path / "a.tar"))
    assert step == 7
    for m in models:
        for k, v in models[m].items():
            np.testing.assert_array_equal(back[m][k], v.numpy())


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_round_trips_to8b(tmp_path, channels):
    rng = np.random.RandomState(channels)
    img = rng.uniform(-0.2, 1.2, (9, 7, channels)).astype(np.float32)
    u8 = to8b(img)
    path = str(tmp_path / "x.png")
    write_png(path, u8 if channels > 1 else u8[..., 0])
    back = np.asarray(imageio.imread(path)).reshape(u8.shape)
    np.testing.assert_array_equal(back, u8)
    with pytest.raises(ValueError):
        write_png(path, img)


def test_render_images_writes_pngs(tmp_path):
    """NeuralSimRenderer.render_images(savedir=...) writes to8b of each
    render as {object_id}/{i:03d}.png."""
    from neuralsim_tpu_torch.bilevel.psi_init import psi_init
    from neuralsim_tpu_torch.config import CameraConfig, RenderConfig
    from neuralsim_tpu_torch.pipeline import NeuralSimRenderer

    net = NeRFNetConfig(netdepth=4, netwidth=16, netdepth_fine=4, netwidth_fine=16, skips=(2,))
    cfg = NeuralSimConfig(net=net, camera=CameraConfig(height=6, width=5, fx=8.0, fy=8.0,
                                                       cx=2.5, cy=3.0),
                          render=RenderConfig(n_samples=4, n_importance=4))
    r = NeuralSimRenderer(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    rgb, _ = r.render_images(psi_init("5"), torch.Generator().manual_seed(1), num_k=2,
                             savedir=str(tmp_path))
    for i in range(2):
        back = np.asarray(imageio.imread(str(tmp_path / "2" / f"{i:03d}.png")))
        np.testing.assert_array_equal(back, to8b(rgb[i]))
