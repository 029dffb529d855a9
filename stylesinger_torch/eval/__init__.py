"""Objective evaluation of generated songs (port of ``stylesinger_tpu/eval``)."""
