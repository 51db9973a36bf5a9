"""A run whose timed path is broken underneath comes out not correct: the
harness's whole run (set-up, window, check) at a tiny size on the CPU,
with one fault planted in the program for each kind the cell can have.
A sound run at that size comes out correct. (The benchmark's cells run on
one card, so no exchange between cards is left out.)"""

import pytest
import torch

from bench_port.tests.tiny import run

RENDER = "render.nerf256.exact_f32.k50"
RENDERS = [RENDER, "render.mipnerf360.exact_bf16.k8"]
TRAIN = "train.nerf256.nrand1024"
BILEVEL = "bilevel.nerf256.k50"


@pytest.fixture(autouse=True)
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("cell", [RENDER, TRAIN, BILEVEL])
def test_sound_run_is_correct(cell, tmp_path):
    result = run(cell, tmpdir=tmp_path)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


def _render_fault(kind):
    from neuralsim_tpu_torch.pipeline import NeuralSimRenderer

    real = NeuralSimRenderer.render_images

    def broken(self, psi, generator=None, num_k=None, savedir=None):
        rgb, noise = real(self, psi, generator=generator, num_k=num_k)
        if kind == "half_batch":
            # half of the poses left out: their images stay empty
            rgb = rgb.clone()
            rgb[rgb.shape[0] // 2:] = 0.0
        else:
            # one answer altered where it is produced
            rgb = rgb.clone()
            rgb[-1, 4:8, 4:8] += 0.05
        return rgb, noise

    return NeuralSimRenderer, "render_images", broken


@pytest.mark.parametrize("cell", RENDERS)
@pytest.mark.parametrize("kind", ["half_batch", "altered"])
def test_render_faults(kind, cell, monkeypatch, tmp_path):
    monkeypatch.setattr(*_render_fault(kind))
    workload_checks = run(cell, tmpdir=tmp_path)
    assert not workload_checks["correct"], workload_checks["checks"]


def _weights_fault(kind):
    """The net the program renders with read wrong: every row of a middle
    trunk layer's weight past its first half left out (a core that drops
    the k-chunks after the first), or the encoding's highest band of the
    point read as zero (a wrong sin / cos past the first bands)."""
    from neuralsim_tpu_torch.pipeline import NeuralSimRenderer

    real = NeuralSimRenderer.__init__

    def broken(self, cfg, models=None, **kw):
        bad = {}
        for name, params in models.items():
            params = dict(params)
            if kind == "late_rows":
                k = params["pts_3_kernel"].clone()
                k[k.shape[0] // 2:] = 0.0
                params["pts_3_kernel"] = k
            else:
                k = params["pts_0_kernel"].clone()
                k[-6:] = 0.0
                params["pts_0_kernel"] = k
            bad[name] = params
        real(self, cfg, models=bad, **kw)

    return NeuralSimRenderer, "__init__", broken


@pytest.mark.parametrize("cell", RENDERS)
@pytest.mark.parametrize("kind", ["late_rows", "pe_band"])
def test_render_weight_faults(kind, cell, monkeypatch, tmp_path):
    monkeypatch.setattr(*_weights_fault(kind))
    result = run(cell, tmpdir=tmp_path)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half_batch"])
def test_train_faults(kind, monkeypatch, tmp_path):
    from neuralsim_tpu_torch import train_nerf

    real = train_nerf.train_step

    def broken(state, rays_o, rays_d, target_rgb, *args, **kw):
        if kind == "unchanged":
            new, metrics = real(state, rays_o, rays_d, target_rgb, *args, **kw)
            return state._replace(step=new.step), metrics
        half = rays_o.shape[0] // 2
        return real(state, rays_o[:half], rays_d[:half], target_rgb[:half], *args, **kw)

    monkeypatch.setattr(train_nerf, "train_step", broken)
    result = run(TRAIN, tmpdir=tmp_path)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
def test_bilevel_faults(kind, monkeypatch, tmp_path):
    from neuralsim_tpu_torch.bilevel import driver

    if kind == "unchanged":
        # the psi step returns its state unchanged
        monkeypatch.setattr(driver, "psi_optimizer_update", lambda state, psi, grad: (state, psi))
    elif kind == "half_batch":
        real = driver.inner_train

        def half(state, batches, dc, *args, **kw):
            data, idx = batches
            return real(state, (data, idx[:, : idx.shape[1] // 2]), dc, *args, **kw)

        monkeypatch.setattr(driver, "inner_train", half)
    else:
        real = driver.BilevelDriver._grad_e

        def altered(self, *args):
            out = real(self, *args)
            return out * 1.5

        monkeypatch.setattr(driver.BilevelDriver, "_grad_e", altered)
    result = run(BILEVEL, tmpdir=tmp_path)
    assert not result["correct"], result["checks"]
