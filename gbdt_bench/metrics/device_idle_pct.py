"""device_idle_pct.<kind>: 100 x (1 - the union of the device operations'
intervals / the wall span) over the profiled iterations or calls."""


def read(ctx):
    p = ctx.get("profile")
    if p is None or not p.device or not p.window_us():
        return None
    return 100.0 * (1.0 - p.busy_us() / p.window_us())
