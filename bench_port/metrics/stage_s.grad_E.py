"""stage_s.grad_E: seconds of the outer iteration's ``grad_E``
stage, per epoch of the window: the driver's own ``phase_timer`` span
(synchronised on entry and exit, ``BilevelDriver.phases``), summed over
the window's epochs and divided by their count. Moves epoch_s."""


def read(ctx):
    value = ctx["record"].get("stage_s", {}).get("grad_E")
    return value if value else None
