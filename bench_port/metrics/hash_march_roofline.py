"""hash_march_roofline: the hash-grid ray march (``csrc/ngp_march.cu``)
against its roofline, in %: the least time of every traced call, each
counted from its shape (rays x samples of its chunk; the larger of the
operations bound at the FP32 peak and the bytes bound at the memory's,
``work_ngp.py``), over the device time of the kernels the workload names
under ``kernels.hash_march``, read from the trace. Nothing when the
program keeps no counters, when the trace's launches differ from the
counter ``fused_ngp_march.calls`` or from the calls' shapes, or when the
counter ``.points`` differs from the points the shapes give. Moves
render_rays_per_s."""

from bench_port.work import bound_s, peaks_for
from bench_port.work_ngp import march_work


def read(ctx):
    rec, trace = ctx["record"], ctx["trace"]
    counted = rec.get("counters")
    if trace is None or counted is None or ctx["card"]["platform"] != "gpu":
        return None
    traced = sum(1 for _, t in rec["calls"] if t)
    seconds, launches = trace.device_seconds(rec["kernels"]["hash_march"])
    shapes = [(n, s) for n in rec["chunks"] for s in rec["samples"]]
    if (traced == 0 or seconds <= 0 or launches != counted["calls"]
            or launches != traced * len(shapes)
            or counted["points"] != traced * sum(n * s for n, s in shapes)):
        return None
    _, peaks = peaks_for(ctx["card"]["kind"])
    least = sum(bound_s(*march_work(rec["hash"], n, s), peaks["float32"], peaks["bytes"])
                for n, s in shapes)
    return 100.0 * traced * least / seconds
