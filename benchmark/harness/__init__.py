"""What every cell of the benchmark shares: finding its files by name
(``registry.py``), the seeded noise and weights it hands to the program and
to the reference (``noise.py``, ``weights.py``), the host-clock arithmetic
(``stats.py``), the spans and the profiled slice of a ``--trace 1`` run
(``spans.py``, ``trace.py``), the numbers compared for ``correct``
(``checks.py``) and the result line (``result.py``)."""
