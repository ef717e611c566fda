from .ops import ewadd, ewmd, ewmm, ewsub
from .ref import ewadd_ref, ewmd_ref, ewmm_ref, ewsub_ref
