from .ops import mvm
from .ref import mvm_ref
