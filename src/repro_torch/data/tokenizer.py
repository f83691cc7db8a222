"""Hash tokenizer, a copy of ``repro.data.tokenizer``: maps
whitespace-split text into a fixed vocab by hashing (the same text gives
the same ids in both packages).

A stand-in for WordPiece when running on real text without shipped vocab
files; synthetic-world experiments bypass it (they generate token ids
directly).  Special ids follow the BERT convention.
"""
from __future__ import annotations

import zlib

PAD, CLS, SEP, MASK = 0, 1, 2, 3
N_SPECIAL = 4


class HashTokenizer:
    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size

    def token_id(self, word: str) -> int:
        h = zlib.crc32(word.lower().encode())
        return N_SPECIAL + h % (self.vocab_size - N_SPECIAL)

    def encode(self, text: str, max_len: int | None = None) -> list[int]:
        ids = [self.token_id(w) for w in text.split()]
        return ids[:max_len] if max_len else ids

    def encode_pair(self, query: str, doc: str, max_query_len: int,
                    max_doc_len: int):
        """-> (tokens, segs, valid) for a [CLS];q;[SEP];d;[SEP] input,
        query padded to ``max_query_len`` (PreTTR fixed doc offset)."""
        q = [CLS] + self.encode(query, max_query_len - 2) + [SEP]
        d = self.encode(doc, max_doc_len - 1) + [SEP]
        q_pad, d_pad = max_query_len - len(q), max_doc_len - len(d)
        tokens = q + [PAD] * q_pad + d + [PAD] * d_pad
        segs = [0] * max_query_len + [1] * max_doc_len
        valid = ([True] * len(q) + [False] * q_pad
                 + [True] * len(d) + [False] * d_pad)
        return tokens, segs, valid
