"""The benchmark of the PyTorch and CUDA port (``stylesinger_torch``):
``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout (see ``BENCHMARK.json``)."""
