"""HALO core runtime for the PyTorch/H100 port (mirrors ``repro.core``)."""
