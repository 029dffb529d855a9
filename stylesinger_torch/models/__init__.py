"""The port's models (``stylesinger_tpu/models``): batch-first [B, T, C]
modules with the flax names of the JAX modules."""

from stylesinger_torch.models.fs2 import FastSpeech2  # noqa: F401
