"""Contextual embeddings without a sentence encoder.

A copy of ``hashing_embedder`` (``gfedntm_tpu/presets.py:26-45``), kept
here so the port never imports the JAX package: the JAX package's
stand-in featurizer for CTM's contextual (SBERT) embeddings, token hashing
plus a signed random projection, L2-normalized. For the same texts and
``dim`` it returns the same float32 array as the original, bit for bit.
The reference consumes precomputed SBERT vectors
(``data_preparation.py:5,25-54``); any embedder with this signature can take
its place.
"""

from __future__ import annotations

import hashlib
from typing import Callable

import numpy as np


def hashing_embedder(dim: int = 768) -> Callable[[list[str]], np.ndarray]:
    """``embed(texts) -> [len(texts), dim]`` float32: each whitespace token
    hashed (BLAKE2b, 8 bytes, little-endian) to a column and a sign, the
    signed counts L2-normalized per text (an empty text stays zero)."""

    def embed(texts: list[str]) -> np.ndarray:
        out = np.zeros((len(texts), dim), dtype=np.float32)
        for i, text in enumerate(texts):
            for tok in text.split():
                h = int.from_bytes(
                    hashlib.blake2b(tok.encode(), digest_size=8).digest(), "little"
                )
                out[i, h % dim] += 1.0 if (h >> 32) & 1 else -1.0
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.where(norms == 0, 1.0, norms)

    return embed
