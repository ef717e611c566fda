"""Serving stack — port of ``repro.serve``: the slot and paged engines, their
step scheduler, the whole-batch front, and the dense and block-paged
caches."""
from .engine import (AdmissionError, AdmissionPolicy, PagedEngine, QoSClass,
                     Request, RequestQueue, ServeEngine, SlotEngine,
                     StepScheduler, sample_tokens)
from .kvcache import (BlockPool, NoFreeBlocks, evict_slot, init_paged,
                      insert_slot, leaf_layout, pad_caches, prefix_block_keys)
