from .ops import smmm
from .ref import bell_to_dense, dense_to_bell, random_block_sparse, smmm_ref
