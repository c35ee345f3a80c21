"""Framework-level persistence of the port: crash-consistent ``save`` /
``load`` of a state tree (``framework/io.py``)."""
