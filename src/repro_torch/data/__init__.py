"""Synthetic token batches and the futurized prefetching pipeline
(``src/repro/data``)."""
