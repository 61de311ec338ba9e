"""optimizer_share: device time of the kernels that the port's
``train/optimizer.py`` launched, over the busy time of the same profiler
window (the one that records Python stacks, two steps)."""


def read(ctx):
    win = ctx.get("stack_profile") if ctx["kind"] == "train" else None
    if win is None or not win.launchers or not win.busy_s:
        return None
    us = sum(t for _, t, _, mod in win.launchers
             if mod.startswith("train/optimizer.py"))
    return 100.0 * us / 1e6 / win.busy_s
