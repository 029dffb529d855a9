"""The bf16 MRF kernel's share of its roofline in the profiled slice: the
least time the slice's MRF work could take (the cost model's FLOP over
the true rows of each stage the kernel takes, each input and output byte
once, against 989 TFLOP/s and 3.35 TB/s), over the device time of the
``mrf_step_bf16_kernel`` launches.  None when no such launch ran."""

KERNEL = "mrf_step_bf16_kernel"


def read(ctx):
    s = ctx.get("slice")
    if s is None:
        return None
    t = sum(v for k, v in s["kernels"].items() if KERNEL in k)
    if t <= 0:
        return None
    return 100.0 * ctx["slice_mrf_bound_s"] / t
