"""ctypes loader for the native BoW tokenizer/vectorizer (``bow.cpp``).

A copy of ``gfedntm_tpu/native/__init__.py`` with ``bow.cpp`` copied byte
for byte, kept here so the port never imports the JAX package and never
loads its library. The shared library is compiled at first use (never at
import) with the system ``g++`` into ``build/gfedntm_tpu_torch/`` at the
repository root (listed in ``.gitignore``), named by a hash of the source,
so later calls and processes pay nothing.

Every public function raises :class:`NativeUnavailable` when the fast path
cannot give *exactly* the counts of the Python tokenizer in
:mod:`gfedntm_tpu_torch.data.vocab`: no compiler, or non-ASCII text (the
C++ matcher implements the ASCII projection of the ``(?u)\\b\\w\\w+\\b``
pattern); a custom token pattern never reaches it. Callers then count in
Python, with the same result: a CountVectorizer parity rule on the host,
not a device fallback. (The JAX package's ``GFEDNTM_NO_NATIVE`` switch
is not copied: the port reads no environment variable of the JAX package.)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "NativeUnavailable",
    "available",
    "count_terms",
    "vectorize",
]

_SRC = Path(__file__).with_name("bow.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gfedntm_tpu_torch"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LOAD_ERROR: str | None = None


class NativeUnavailable(RuntimeError):
    """The native fast path cannot serve this request; use the Python path."""


def _compile() -> Path:
    src = _SRC.read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"bow_{digest}.so"
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
        str(_SRC), "-o", str(tmp),
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)  # atomic: concurrent compiles race benignly
    return out


def _get_lib() -> ctypes.CDLL:
    global _LIB, _LOAD_ERROR
    if _LIB is not None:
        return _LIB
    if _LOAD_ERROR is not None:
        raise NativeUnavailable(_LOAD_ERROR)
    with _LOCK:
        if _LIB is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(str(_compile()))
        except (OSError, subprocess.CalledProcessError, FileNotFoundError) as e:
            _LOAD_ERROR = f"native bow build failed: {e}"
            raise NativeUnavailable(_LOAD_ERROR) from e
        lib.gfed_vectorize.restype = ctypes.c_int
        lib.gfed_vectorize.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ]
        lib.gfed_count_terms.restype = ctypes.c_int64
        lib.gfed_count_terms.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ]
        lib.gfed_free.restype = None
        lib.gfed_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def available() -> bool:
    try:
        _get_lib()
        return True
    except NativeUnavailable:
        return False


def _pack(strings, what: str) -> tuple[bytes, np.ndarray]:
    """One UTF-8 blob + int64 offsets[n+1]; rejects non-ASCII (the C++
    tokenizer implements the ASCII projection of the unicode pattern)."""
    encoded = []
    for s in strings:
        if not s.isascii():
            raise NativeUnavailable(f"non-ASCII {what}; use the Python path")
        encoded.append(s.encode())
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return b"".join(encoded), offsets


def vectorize(docs, vocab_tokens, lowercase: bool = True) -> np.ndarray:
    """Dense [n_docs, n_vocab] float32 count matrix against a fixed
    vocabulary — the native twin of :func:`gfedntm_tpu_torch.data.vocab.vectorize`."""
    lib = _get_lib()
    docs_blob, doc_off = _pack(docs, "document")
    vocab_blob, vocab_off = _pack(vocab_tokens, "vocabulary token")
    out = np.zeros((len(docs), len(vocab_tokens)), dtype=np.float32)
    rc = lib.gfed_vectorize(
        docs_blob, doc_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(docs),
        vocab_blob, vocab_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(vocab_tokens),
        int(lowercase),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:  # pragma: no cover - no failing path today
        raise NativeUnavailable(f"gfed_vectorize returned {rc}")
    return out


def count_terms(docs, lowercase: bool = True) -> dict[str, int]:
    """Corpus-wide term frequencies (token occurrences) — the counting core
    of :func:`gfedntm_tpu_torch.data.vocab.build_vocabulary`."""
    lib = _get_lib()
    docs_blob, doc_off = _pack(docs, "document")
    tokens_ptr = ctypes.c_char_p()
    tokens_len = ctypes.c_int64()
    counts_ptr = ctypes.POINTER(ctypes.c_int64)()
    n = lib.gfed_count_terms(
        docs_blob, doc_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(docs), int(lowercase),
        ctypes.byref(tokens_ptr), ctypes.byref(tokens_len),
        ctypes.byref(counts_ptr),
    )
    if n < 0:  # pragma: no cover - allocation failure
        raise NativeUnavailable("gfed_count_terms allocation failed")
    try:
        blob = ctypes.string_at(tokens_ptr, tokens_len.value)
        counts = np.ctypeslib.as_array(counts_ptr, shape=(n,)).copy() if n else []
        terms = blob.decode().split("\n")[:n]
        return {t: int(c) for t, c in zip(terms, counts)}
    finally:
        lib.gfed_free(tokens_ptr)
        lib.gfed_free(counts_ptr)
