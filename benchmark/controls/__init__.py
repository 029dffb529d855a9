"""What sets the limits of ``correct``: the readings over seeds of the
program, the control and the planted faults (``readings.py``,
``faults.py``)."""
