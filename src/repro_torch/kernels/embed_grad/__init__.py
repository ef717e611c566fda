from .ops import embed_grad
from .ref import embed_grad_ref
