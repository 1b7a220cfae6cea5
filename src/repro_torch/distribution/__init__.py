"""Distribution recipes and logical-axis rules (``src/repro/distribution``);
the mesh half of the sharding tooling comes with ROADMAP item 11."""
