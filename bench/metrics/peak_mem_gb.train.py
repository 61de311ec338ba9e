"""peak_mem_gb.train: torch.cuda.max_memory_allocated() over the window,
in GB (1e9 bytes)."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["window_peak_bytes"]:
        return None
    return ctx["window_peak_bytes"] / 1e9
