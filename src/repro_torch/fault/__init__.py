"""Heartbeats and straggler detection (``src/repro/fault/monitor.py``)."""
