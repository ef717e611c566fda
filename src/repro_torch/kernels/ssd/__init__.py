"""SSD (Mamba-2 state-space duality): the ``torch`` scan, the ``aten``
chunked form and the O(1) decode step.  No ``hopper`` row: the reference
has no Pallas SSD (its chunked form is already matmul-shaped)."""
from .ops import ssd_chunked, ssd_decode_step
from .ref import ssd_ref
