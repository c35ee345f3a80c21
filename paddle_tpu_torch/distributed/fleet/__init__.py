"""The fleet layer of the port's distributed runtime: elastic training
(``fleet/elastic.py``: heartbeats, scale requests, the elastic
supervisor)."""
