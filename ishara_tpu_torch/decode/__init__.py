from .greedy import greedy_decode

__all__ = ["greedy_decode"]
