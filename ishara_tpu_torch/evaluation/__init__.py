from .metrics import character_error_rate, levenshtein, normalized_levenshtein

__all__ = ["character_error_rate", "levenshtein", "normalized_levenshtein"]
