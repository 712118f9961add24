from .autoregressive import (
    beam_translate_cached,
    greedy_translate,
    greedy_translate_cached,
)
from .beam import beam_decode_batch, ctc_beam_search
from .beam_device import beam_decode_device_batch, beam_search_device
from .greedy import greedy_decode, greedy_decode_batch

__all__ = ["beam_decode_batch", "beam_decode_device_batch",
           "beam_search_device", "beam_translate_cached", "ctc_beam_search",
           "greedy_decode", "greedy_decode_batch", "greedy_translate",
           "greedy_translate_cached"]
