"""Runtime health for the port: the phase watchdog and deadline executor
(``runtime/watchdog.py``) and replica liveness by heartbeat
(``runtime/health.py``)."""
