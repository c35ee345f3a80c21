"""Runtime health for the port: the phase watchdog
(``runtime/watchdog.py``) that the serving engine's ``serve.step``
phase runs under."""
