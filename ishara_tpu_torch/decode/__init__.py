from .greedy import greedy_decode, greedy_decode_batch

__all__ = ["greedy_decode", "greedy_decode_batch"]
