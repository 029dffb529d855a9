"""The training step's share of the chip's peak in the profiled slice: 3 x
the cost model's FLOP of the training pass over the slice's items at their
true lengths, over the slice's wall time, against the bf16 dense peak of
989 TFLOP/s (the model trains in f32: no change of precision can carry it
past 100 %)."""

PEAK = 989e12


def read(ctx):
    s = ctx.get("slice")
    if s is None or not ctx.get("slice_flops"):
        return None
    return 100.0 * ctx["slice_flops"] / (s["window_s"] * PEAK)
