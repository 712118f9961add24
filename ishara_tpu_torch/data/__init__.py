from . import landmarks, vocab
from .tokenizer import CTCTokenizer, Seq2SeqTokenizer

__all__ = ["landmarks", "vocab", "CTCTokenizer", "Seq2SeqTokenizer"]
