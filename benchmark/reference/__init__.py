"""The benchmark's plain references (``plain/``) and what works results out
again from the same inputs and weights as the program (``synth.py``,
``vocode.py``)."""
