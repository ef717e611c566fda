"""MOE_FFN (the grouped per-expert SwiGLU FFN): the ``torch`` oracle and the
``aten`` batched products.  No ``hopper`` row: the reference has no Pallas
MOE_FFN (its products are einsums XLA lowers outside any Pallas kernel),
and the port adds no kernel the JAX package lacks."""
from .ops import grouped_ffn
from .ref import grouped_ffn_ref
