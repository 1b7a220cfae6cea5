"""Roofline analysis of the port's dry run (``src/repro/analysis/`` on PyTorch):
``op_analysis`` (the op table of one device's step), ``roofline`` (H100
terms) and ``perf_lab`` (overrides and diffs)."""
