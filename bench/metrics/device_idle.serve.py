"""device_idle.serve: share of the serving profiler window (the cell's own
traffic, no Python stacks recorded) in which nothing ran on the device."""


def read(ctx):
    win = ctx["profile"] if ctx["kind"] == "serve" else None
    if win is None or not win.wall_s:
        return None
    return 100.0 * max(0.0, 1.0 - win.busy_s / win.wall_s)
