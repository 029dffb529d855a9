"""Training data: the binarized shards, the dataset and the static-shape
batcher (port of ``stylesinger_tpu/data``)."""
