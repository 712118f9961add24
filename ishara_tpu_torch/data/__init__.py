from . import landmarks, vocab
from .tokenizer import CTCTokenizer

__all__ = ["landmarks", "vocab", "CTCTokenizer"]
