"""Asynchronous checkpointing in the JAX package's format
(``src/repro/checkpoint``)."""
