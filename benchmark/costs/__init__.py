"""Operation and byte counts of each configuration's work, written from
its widths and the inputs' true lengths (``<config>.py``)."""
