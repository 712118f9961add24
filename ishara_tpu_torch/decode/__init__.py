from .autoregressive import (
    beam_translate_cached,
    greedy_translate,
    greedy_translate_cached,
)
from .greedy import greedy_decode, greedy_decode_batch

__all__ = ["beam_translate_cached", "greedy_decode", "greedy_decode_batch",
           "greedy_translate", "greedy_translate_cached"]
