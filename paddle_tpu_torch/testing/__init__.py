"""Test harnesses of the port: deterministic fault injection
(``testing/chaos.py``)."""
