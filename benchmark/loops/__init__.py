"""The loops that drive a cell: set-up, the timed window, the traced
slice and the check (``<loop>.py``, named by a workload file)."""
