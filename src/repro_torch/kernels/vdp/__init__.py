from .ops import vdp
from .ref import vdp_ref
