"""Serving on PyTorch: prefill and greedy decode steps."""
