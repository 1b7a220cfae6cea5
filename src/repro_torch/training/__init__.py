"""Training: AdamW, the microbatched train step, int8 gradient compression
and elastic data-parallel training over local workers (``src/repro/training``)."""
