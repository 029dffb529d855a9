"""The whole request's share of the chip's peak in the profiled slice: the
cost model's FLOP of the work the slice's inputs need (true lengths, not
padding) over the slice's wall time, against the bf16 dense peak of 989
TFLOP/s whatever precision a part runs in."""

PEAK = 989e12


def read(ctx):
    s = ctx.get("slice")
    if s is None or not ctx.get("slice_flops"):
        return None
    return 100.0 * ctx["slice_flops"] / (s["window_s"] * PEAK)
