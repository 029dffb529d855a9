"""One reader per per-layer metric (``<metric>.py``): ``read(ctx)``
returns the metric's value, or None where the run has nothing to read."""
