"""Training of the StyleSinger acoustic model (port of ``stylesinger_tpu/training``)."""
