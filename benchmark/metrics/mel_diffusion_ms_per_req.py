"""Mel diffusion milliseconds per request: device seconds of the port's
``acoustic.mel_diffusion`` span (``models/stylesinger.py``: the mel
sampler that runs, between two CUDA events) over the requests of
``infer_batch``, in the profiled slice."""

from benchmark.harness.program import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit("acoustic.mel_diffusion", "infer_batch")
