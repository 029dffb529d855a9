"""The share of the profiled slice of training windows (CUDA graph
replays) in which no kernel, copy or set ran on the device."""


def read(ctx):
    s = ctx.get("slice")
    if s is None or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
