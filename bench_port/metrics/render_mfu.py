"""render_mfu: the renders' model FLOPs over their time and the dtype's
peak, in %. FLOPs: 2 x multiply-adds a point x (coarse + fine samples) a
ray x rays; the exact render marches every sample, so the count does not
depend on the data. Time: the host clock of the window's measured
render_images calls, each synchronised (the traced calls after them are
left out). Moves render_rays_per_s."""

from bench_port.work import macs_per_point, peaks_for


def read(ctx):
    rec = ctx["record"]
    calls = [d for d, traced in rec["calls"] if not traced]
    if not calls or ctx["card"]["platform"] != "gpu":
        return None
    flop = 2.0 * macs_per_point(rec["net"]) * sum(rec["samples"]) * rec["rays_per_call"]
    _, peaks = peaks_for(ctx["card"]["kind"])
    return 100.0 * flop * len(calls) / sum(calls) / peaks[rec["dtype"]]
