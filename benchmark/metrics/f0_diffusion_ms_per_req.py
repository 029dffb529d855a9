"""F0 diffusion milliseconds per request: device seconds of the port's
``acoustic.f0_diffusion`` span (``models/stylesinger.py``: both F0 chains
of ``sample_gm_dual``, between two CUDA events) over the requests of
``infer_batch``, in the profiled slice."""

from benchmark.harness.program import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit("acoustic.f0_diffusion", "infer_batch")
