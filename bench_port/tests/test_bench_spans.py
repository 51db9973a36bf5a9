"""The span table (``bench_port/spans.py``): its reduction of Chrome-trace
events, that the program's spans leave the trace's summary as it was, the
readings' refusals and values, the span counts of each cell's traced work
at a tiny size on the CPU, and (on the card) the weight packs a render and
a NeRF step open."""

import dataclasses

import pytest
import torch

from bench_port import spans, trace
from bench_port.tests.tiny import tiny


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events(program_ranges=True):
    """A stretch of 100 us: two ``step`` spans (the second holding a nested
    ``pack``), kernels launched in each, one launched outside every span,
    and one whose correlation matches no launch."""
    out = [_x(trace.STRETCH, "user_annotation", 0.0, 100.0),
           _x("stage", "user_annotation", 0.0, 100.0),
           # launches on the host
           _x("cudaLaunchKernel", "cuda_runtime", 5.0, 1.0, corr=1),
           _x("cudaLaunchKernel", "cuda_runtime", 8.0, 1.0, corr=2),
           _x("cuLaunchKernel", "cuda_driver", 45.0, 1.0, corr=3),
           _x("cudaLaunchKernel", "cuda_runtime", 55.0, 1.0, corr=4),
           _x("cudaLaunchKernel", "cuda_runtime", 90.0, 1.0, corr=5),
           # kernels on the device
           _x("direct_copy_kernel_cuda", "kernel", 10.0, 20.0, corr=1),
           _x("gemm", "kernel", 30.0, 10.0, corr=2),
           _x("pack_copy_kernel", "kernel", 50.0, 5.0, corr=3),
           _x("gemm", "kernel", 60.0, 10.0, corr=4),
           _x("late", "kernel", 92.0, 4.0, corr=5),
           _x("orphan", "kernel", 80.0, 2.0, corr=99),
           _x("memcpy", "gpu_memcpy", 40.0, 5.0)]
    if program_ranges:
        out += [_x("step", "user_annotation", 0.0, 20.0),
                _x("step", "user_annotation", 40.0, 30.0),
                _x("pack", "user_annotation", 44.0, 4.0)]
    return out


def test_span_table_counts_launches_and_busy_time():
    t = spans.span_table(_events())
    assert t.kernels == 6 and t.unmatched == 1
    step = t.spans["step"]
    assert step.count == 2
    assert step.host_s == pytest.approx(50e-6)
    # busy [10, 45) + [50, 55) + [60, 70) + [80, 82) + [92, 96) inside
    # [0, 20) + [40, 70): 10 + 5 + 5 + 10
    assert step.busy_s == pytest.approx(30e-6)
    # launched at 5, 8 (first span), 45 (nested pack) and 55 (second span)
    assert step.kernels == 4
    assert step.device_s == pytest.approx(45e-6)
    pack = t.spans["pack"]
    assert (pack.count, pack.kernels) == (1, 1)
    assert pack.device_s == pytest.approx(5e-6)
    assert t.spans["stage"].kernels == 5                 # the orphan has no launch
    assert t.kernel_seconds("step", ["copy_kernel"]) == (pytest.approx(25e-6), 2)
    assert trace.STRETCH not in t.spans
    assert spans.span_table([_x("k", "kernel", 0.0, 1.0)]) is None


def test_program_ranges_leave_the_summary_as_it_was():
    with_ranges = trace.summarize(_events(True))
    without = trace.summarize(_events(False))
    assert with_ranges.window_s == without.window_s
    assert with_ranges.busy_s == without.busy_s
    assert with_ranges.kernels == without.kernels
    assert with_ranges.top_ops() == without.top_ops()


CELLS = {"bilevel.nerf256.k50": ("inner_train", 1),
         "render.nerf256.exact_f32.k50": ("render_images", 2),
         "train.nerf256.nrand1024": ("train_step", 50)}
GPU = {"platform": "gpu"}


def _table(cell, scale=1):
    """A hand-made table of the cell's traced units at the full-size
    configuration, every span at the count expected (times ``scale``)."""
    w, c = _files(cell)
    unit, n = CELLS[cell]
    table = spans.SpanTable({unit: spans.SpanStats(n, 1.0, 0.5, 10, 0.5)}, 0, 0)
    for name, count in spans.expected_counts(table, w, c).items():
        table.spans[name] = spans.SpanStats(count * scale, 2.0 * count, 0.5 * count,
                                            30 * count, 0.4 * count)
    table.launched["render_grad.strip"] = [("direct_copy_kernel_cuda", 1e5), ("gemm", 3e5)]
    return table


def _files(cell):
    from bench_port import harness

    w = harness.workload_spec(cell)
    return w, harness.config_spec(w["config"])


def test_expected_counts_of_the_cells():
    counts = {cell: spans.expected_counts(_table(cell), *_files(cell)) for cell in CELLS}
    assert counts["bilevel.nerf256.k50"] == {"inner_train.step": 50, "grad_E.image": 50,
                                             "render_grad.strip": 100}
    # 2 calls of 62 chunks; a render with the same weights packs nothing
    assert counts["render.nerf256.exact_f32.k50"] == {"render.chunk": 124,
                                                      "kernels.pack_weights": 0}
    assert counts["train.nerf256.nrand1024"] == {"train_nerf.step": 50,
                                                 "kernels.pack_weights": 100}


@pytest.mark.parametrize("cell", list(CELLS))
def test_readings_refuse_without_trace_off_card_and_on_a_wrong_count(cell):
    w, c = _files(cell)
    names = [m for m, _, _ in spans.METRICS[w["entry"]]]
    assert spans.readings(None, w, c, GPU) == {m: None for m in names}
    assert spans.readings(_table(cell), w, c, {"platform": "cpu"}) == {m: None for m in names}
    assert spans.readings(_table(cell, scale=2), w, c, GPU) == {m: None for m in names}
    # a span left out altogether
    table = _table(cell)
    for _, name, _ in spans.METRICS[w["entry"]]:
        table.spans.pop(name, None)
    assert spans.readings(table, w, c, GPU) == {m: None for m in names}


@pytest.mark.parametrize("cell", list(CELLS))
def test_readings_of_a_hand_made_table(cell):
    w, c = _files(cell)
    got = spans.readings(_table(cell), w, c, GPU)
    want = {"bilevel.nerf256.k50": {"launches.inner_step": 30.0, "busy_share.inner_step": 25.0,
                                    "launches.grad_E_image": 30.0,
                                    "busy_share.grad_E_image": 25.0,
                                    # 0.1 of 40 s
                                    "cast_share.render_grad_strip": 0.25},
            "render.nerf256.exact_f32.k50": {"launches.render_chunk": 30.0},
            "train.nerf256.nrand1024": {"launches.train_step": 30.0,
                                        "launches.weight_pack": 30.0}}[cell]
    assert got == pytest.approx(want)


@pytest.fixture
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("cell", list(CELLS))
def test_traced_cells_open_the_expected_spans(cell, tmp_path, threads):
    """A traced run of the cell at a tiny size on the CPU: every span the
    cell's traced work implies, at its count (no kernels there, so no
    weight pack)."""
    w, c = tiny(cell)
    result, table = spans.traced_run(cell, 3, 0.5, device="cpu", workload=w, config=c,
                                     tmpdir=tmp_path)
    assert result["correct"], result["checks"]
    want = spans.expected_counts(table, w, c)
    want["kernels.pack_weights"] = 0
    got = {name: table.spans[name].count if name in table.spans else 0 for name in want}
    assert got == want and all(n > 0 for k, n in want.items() if k != "kernels.pack_weights")
    if w["entry"] == "train_step":
        step = table.spans["train_nerf.step"]
        assert all(table.spans[f"train_nerf.{k}"].count == step.count
                   for k in ("forward", "backward", "update"))
    assert spans.readings(table, w, c, result["device"]) == {
        m: None for m, _, _ in spans.METRICS[w["entry"]]}


@pytest.mark.card
def test_weight_packs_on_the_card(card, tmp_path):
    """A second render with the same weights prepares none (a cache hit),
    a NeRF step prepares both nets' new weights: 2; every kernel of the
    stretch matches its launch."""
    from torch.profiler import ProfilerActivity, profile

    from neuralsim_tpu_torch import set_card_numerics
    from neuralsim_tpu_torch.pipeline import NeuralSimRenderer
    from neuralsim_tpu_torch.train_nerf import init_train_state, train_step

    from bench_port.cells import program_config
    from bench_port.reference.psi_init import psi_init

    w, c = tiny("render.nerf256.exact_f32.k50")
    cfg = program_config(c, w)
    set_card_numerics(card)
    state = init_train_state(cfg.net, cfg.render, cfg.train, torch.Generator(card).manual_seed(0),
                             card)
    renderer = NeuralSimRenderer(cfg, models=state.params, device=card)
    psi = psi_init("5")
    rc = dataclasses.replace(cfg.render, perturb=True)
    g = torch.Generator(card).manual_seed(1)
    rays_o = torch.zeros(256, 3, device=card) + torch.tensor([0.0, 0.0, -1.0], device=card)
    rays_d = torch.nn.functional.normalize(torch.randn(256, 3, device=card, generator=g) * 0.1
                                           + torch.tensor([0.0, 0.0, 1.0], device=card), dim=-1)
    target = torch.rand(256, 3, device=card, generator=g)

    def traced(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(trace.STRETCH):
                out = fn()
                torch.cuda.synchronize()
        path = tmp_path / "trace.json"
        prof.export_chrome_trace(str(path))
        import json

        return out, spans.span_table(json.loads(path.read_text())["traceEvents"])

    renderer.render_images(psi, generator=torch.Generator().manual_seed(2), num_k=2)
    _, table = traced(lambda: renderer.render_images(
        psi, generator=torch.Generator().manual_seed(3), num_k=2))
    assert "kernels.pack_weights" not in table.spans
    assert table.spans["render.chunk"].count > 0 and table.kernels > 0
    assert table.unmatched == 0
    (state, _), table = traced(lambda: train_step(state, rays_o, rays_d, target, cfg.net, rc,
                                                  cfg.train, generator=g))
    assert table.spans["kernels.pack_weights"].count == 2
    assert table.spans["train_nerf.step"].count == 1
    assert table.unmatched == 0
