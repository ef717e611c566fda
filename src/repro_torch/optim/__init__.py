from .adamw import AdamWState, adamw_init, adamw_update
from .schedule import cosine_schedule, linear_warmup_cosine
from .compression import compress_gradients, decompress_gradients
