"""Training data: preprocess and binarize (raw corpus -> shards), the
pickled and TSD shards, the datasets and the static-shape batchers (port
of ``stylesinger_tpu/data``)."""
