"""march_roofline: kernel 1 (the ray march, ``csrc/nerf_march.cu``) against
its roofline, in %: the least time of every kernel-1 call of the traced
stretch, each counted from its shape (rays x samples of its chunk; the
larger of the operations and bytes bounds at the card's peaks), over the
device time of the kernels the workload names under ``kernels.march``,
read from the trace. Nothing when the trace holds another number of those
kernels than the calls' shapes give. Moves render_rays_per_s."""

from bench_port.work import bound_s, march_work, peaks_for, weight_bytes


def read(ctx):
    rec, trace = ctx["record"], ctx["trace"]
    if trace is None or ctx["card"]["platform"] != "gpu":
        return None
    traced = sum(1 for _, t in rec["calls"] if t)
    seconds, launches = trace.device_seconds(rec["kernels"]["march"])
    if traced == 0 or launches != traced * len(rec["chunks"]) * len(rec["samples"]) \
            or seconds <= 0:
        return None
    _, peaks = peaks_for(ctx["card"]["kind"])
    wbytes = weight_bytes(rec["net"], rec["dtype"])
    least = sum(bound_s(*march_work(rec["net"], n, s, wbytes), peaks[rec["dtype"]],
                        peaks["bytes"]) for n in rec["chunks"] for s in rec["samples"])
    return 100.0 * traced * least / seconds
