"""idle_share.render: the share of the traced stretch in which no operation
ran on the card, in %: one minus the union of the device's activity
intervals (kernels, copies, sets) over the stretch's length. Nothing
without a trace. Moves render_rays_per_s."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace.window_s <= 0 or ctx["card"]["platform"] != "gpu":
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
