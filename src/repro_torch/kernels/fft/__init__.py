from .ops import fft
from .ref import fft_ref
