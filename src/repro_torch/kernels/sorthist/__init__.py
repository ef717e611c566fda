from .ops import hist, sort
from .ref import hist_ref, sort_ref
