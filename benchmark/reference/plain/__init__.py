"""Plain PyTorch forms of StyleSinger's inference path, frozen from the
port (``stylesinger_torch``) with its two hand-written kernels replaced by
their plain twins (``kernels_plain.py``) and its data-parallel reductions by
one process's (``local.py``).  Nothing here imports the port or JAX; the
benchmark's comparisons and its controls run these modules."""
