"""Single-device training: AdamW, the microbatched train step and int8
gradient compression (``src/repro/training``)."""
