"""Optimizer milliseconds per training step: device time of the port's
``train.optimizer`` span (``training/step.py::train_step``: the global
norm, Adam's moments and the update), which the CUDA graph of the step
records as a pair of timing events in every replay; the last replay of
each graph, weighted by its replays."""

from benchmark.harness.program import graph_ms_per_step


def read(ctx):
    return graph_ms_per_step("train.optimizer")
