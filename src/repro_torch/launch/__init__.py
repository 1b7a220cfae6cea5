"""Launchers: the end-to-end training driver (``src/repro/launch/train.py``)."""
