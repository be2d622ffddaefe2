"""Byte-level tokenizer (no external vocab files).

ids: 0=PAD, 1=BOS, 2=EOS, bytes b -> b+3. Vocab padded to a multiple of 64
so the vocab dim shards cleanly on the ``model`` mesh axis.
"""
from __future__ import annotations

import numpy as np

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
_OFFSET = 3


class ByteTokenizer:
    def __init__(self, vocab_size: int = 320):
        assert vocab_size >= 256 + _OFFSET
        self.vocab_size = vocab_size
        self.pad_id = PAD_ID
        self.bos_id = BOS_ID
        self.eos_id = EOS_ID

    def encode(self, text: str, *, bos: bool = True, eos: bool = False) -> list:
        ids = [b + _OFFSET for b in text.encode("utf-8")]
        if bos:
            ids = [BOS_ID] + ids
        if eos:
            ids = ids + [EOS_ID]
        return ids

    def decode(self, ids) -> str:
        bs = bytes(int(i) - _OFFSET for i in ids
                   if int(i) >= _OFFSET and int(i) < 256 + _OFFSET)
        return bs.decode("utf-8", errors="replace")

    def encode_batch(self, texts, max_len: int, *, bos=True, eos=False):
        """Right-padded (B, max_len) int32 + lengths (B,)."""
        out = np.full((len(texts), max_len), PAD_ID, np.int32)
        lens = np.zeros((len(texts),), np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t, bos=bos, eos=eos)[:max_len]
            out[i, : len(ids)] = ids
            lens[i] = len(ids)
        return out, lens
