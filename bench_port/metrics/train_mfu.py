"""train_mfu: the train steps' model FLOPs over their time and the FP32
peak, in %: 6 x multiply-adds a point x N_rand x the points a ray marches
(64 coarse, then 64 + 128 fine: 256) per step, forward and backward of
every point (the backward's recompute is not counted), over the measured
steps' host time (the traced steps after them are left out). Moves
train_step_ms."""

from bench_port.work import macs_per_point, peaks_for


def read(ctx):
    rec = ctx["record"]
    if ctx["card"]["platform"] != "gpu":
        return None
    steps, seconds = rec["steps"], 1e-3 * ctx["e2e"]["train_step_ms"] * rec["steps"]
    flop = 6.0 * macs_per_point(rec["net"]) * rec["n_rand"] * rec["samples"]
    _, peaks = peaks_for(ctx["card"]["kind"])
    return 100.0 * flop * steps / seconds / peaks["float32"]
