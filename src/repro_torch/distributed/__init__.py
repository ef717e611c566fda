"""Distribution helpers — port of ``repro.distributed`` (one device only)."""
