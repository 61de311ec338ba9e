"""device_idle.train: share of the training profiler window in which no
kernel, copy or memset ran on the device."""


def read(ctx):
    win = ctx.get("profile") if ctx["kind"] == "train" else None
    if win is None or not win.wall_s:
        return None
    return 100.0 * max(0.0, 1.0 - win.busy_s / win.wall_s)
