"""CPU tests of the benchmark: ``python -m pytest benchmark/tests``.  A
test that needs the card is marked ``cuda`` (the marker of the repo's
pytest settings) and skips here; on the GPU machine: ``python -m pytest
-m cuda benchmark/tests``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
