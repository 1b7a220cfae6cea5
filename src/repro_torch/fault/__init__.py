"""Heartbeats, straggler detection and seeded fault injection
(``src/repro/fault``)."""
