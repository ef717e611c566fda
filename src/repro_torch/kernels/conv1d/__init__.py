from .ops import conv1d
from .ref import conv1d_ref
