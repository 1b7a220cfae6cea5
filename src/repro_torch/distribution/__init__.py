"""Distribution recipes and logical-axis rules (``src/repro/distribution``);
the mesh half of the sharding tooling maps them onto a ``DeviceMesh``."""
