from .ops import mmm
from .ref import mmm_ref
