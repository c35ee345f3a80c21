"""Framework-level pieces of the port: crash-consistent ``save`` /
``load`` of a state tree (``framework/io.py``), the global random state
(``framework/random.py``) and ``ParamAttr``."""
