"""Tokenizers for the serving stack (port of ray_tpu/llm/tokenizer.py).

A dependency-free byte-level tokenizer (hermetic tests, no downloads) and an
optional Hugging Face wrapper, imported only when asked for.
"""
from __future__ import annotations

from typing import List, Protocol


class Tokenizer(Protocol):
    eos_token_id: int
    vocab_size: int

    def encode(self, text: str) -> List[int]: ...
    def decode(self, ids: List[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes + offset; ids 0..=2 reserved (0=pad, 1=bos, 2=eos)."""

    _OFFSET = 3

    def __init__(self):
        self.pad_token_id = 0
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.vocab_size = 256 + self._OFFSET

    def encode(self, text: str) -> List[int]:
        return [self.bos_token_id] + [b + self._OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: List[int]) -> str:
        # ids beyond the byte range (a model vocab may exceed 256+3) are dropped,
        # like special/unknown tokens in a real tokenizer's skip_special_tokens path
        data = bytes(i - self._OFFSET for i in ids
                     if self._OFFSET <= i < self._OFFSET + 256)
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """transformers.AutoTokenizer wrapper (local paths only in hermetic envs)."""

    def __init__(self, name_or_path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(name_or_path)
        self.eos_token_id = self._tok.eos_token_id
        self.vocab_size = len(self._tok)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text)

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


def get_tokenizer(spec: str) -> Tokenizer:
    if spec == "byte":
        return ByteTokenizer()
    if spec.startswith("hf:"):
        return HFTokenizer(spec[3:])
    raise ValueError(f"unknown tokenizer spec: {spec!r}")
