"""DME region: hardware-agnostic model definitions — port of
``repro.models``.

Every perf-critical op routes through ``halo_dispatch``: model code names
functional aliases (MMM, RMSNORM, FLASH_ATTN), never backends.
"""
from .transformer import Model, build_model
