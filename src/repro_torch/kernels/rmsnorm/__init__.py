from .ops import rmsnorm
from .ref import rmsnorm_ref
