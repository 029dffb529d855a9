"""Traffic generators (``<generator>.py``) and the mixes they read
(``<traffic>.json``)."""
