"""Test harnesses of the port: deterministic fault injection
(``testing/chaos.py``) and the op sweep's cases (``testing/op_cases.py``,
run by the CPU tests against JAX and by ``chip_smoke.py`` on the card)."""
