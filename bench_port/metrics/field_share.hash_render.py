"""field_share.hash_render: the share of the card's busy time in the traced
stretch that the hash-grid ray march takes, in %: the device seconds of
the kernels the workload names under ``kernels.hash_march`` over the
union of the device's activity (kernels, copies, sets). Near 100%, the
field sets the pace; lower, the render's other stages (sampling, sorting,
compositing, their launches) do. Nothing without a trace or without a
kernel of that name. Moves render_rays_per_s."""


def read(ctx):
    rec, trace = ctx["record"], ctx["trace"]
    if trace is None or trace.busy_s <= 0 or ctx["card"]["platform"] != "gpu":
        return None
    seconds, launches = trace.device_seconds(rec["kernels"]["hash_march"])
    if launches == 0:
        return None
    return 100.0 * seconds / trace.busy_s
