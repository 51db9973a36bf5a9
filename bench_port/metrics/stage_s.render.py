"""stage_s.render: seconds of the outer iteration's ``render``
stage, per epoch of the window: the driver's own ``phase_timer`` span
(synchronised on entry and exit, ``BilevelDriver.phases``), summed over
the window's epochs and divided by their count. Moves epoch_s."""


def read(ctx):
    value = ctx["record"].get("stage_s", {}).get("render")
    return value if value else None
