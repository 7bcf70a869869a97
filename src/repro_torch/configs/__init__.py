"""Per-architecture configurations of the port (copies of ``repro.configs``)."""
