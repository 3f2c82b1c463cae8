"""Plain float32 references, one file per configuration
(``<config>.py``), and the pieces they share (``common.py``)."""
