"""The hash-grid cell (``render.ngp.exact_f32.k50``) at a tiny size on the
CPU: the harness's whole run (set-up, window, check) comes out correct,
and a fault planted in the program's field comes out not correct at the
workload's own limits. The field keeps its published settings (16 levels,
2^19 entries a level, 16-2048); only the camera, the samples and K are
cut, by ``tiny.py``."""

import pytest
import torch

from bench_port import harness
from bench_port.tests.tiny import tiny

CELL = "render.ngp.exact_f32.k50"


@pytest.fixture(autouse=True)
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def run(tmp_path, trace=False):
    w, c = tiny(CELL)
    w["traffic"]["poses"] = 2
    return harness.run_cell(CELL, 3, 0.5, trace, device="cpu", workload=w, config=c,
                            tmpdir=tmp_path)


def test_sound_run_is_correct(tmp_path):
    result = run(tmp_path)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"render_rays_per_s", "setup_s"}


def test_traced_run_off_the_card_reads_no_device_metric(tmp_path):
    result = run(tmp_path, trace=True)
    assert result["correct"], result["checks"]
    assert result["metrics"] == {}


def _planted(kind):
    """(module, attribute, value): one fault in the program's field."""
    from neuralsim_tpu_torch.models import ngp

    if kind == "finest_level_dropped":
        real = ngp.hash_encode

        def encode(table, u, net):
            enc = real(table, u, net).clone()
            enc[:, -ngp.FEATURES:] = 0.0
            return enc

        return ngp, "hash_encode", encode
    if kind == "hash_prime_changed":
        return ngp, "PRIMES", (1, 2654435761, 805459867)
    if kind == "dense_switch_moved":
        real = ngp.level_layout

        def layout(net):
            levels = real(net)
            last = max(i for i, lv in enumerate(levels) if lv.dense)
            levels[last] = levels[last]._replace(dense=False)
            return levels

        return ngp, "level_layout", layout
    assert kind == "sh_degree_3"
    real_sh = ngp.sh_encode

    def sh(d):
        out = real_sh(d).clone()
        out[:, 9:] = 0.0
        return out

    return ngp, "sh_encode", sh


@pytest.mark.parametrize("kind", ["finest_level_dropped", "hash_prime_changed",
                                  "dense_switch_moved", "sh_degree_3"])
def test_planted_fault_is_not_correct(kind, monkeypatch, tmp_path):
    monkeypatch.setattr(*_planted(kind))
    result = run(tmp_path)
    assert not result["correct"], result["checks"]
