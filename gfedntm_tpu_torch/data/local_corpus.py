"""Offline real-text corpus: Python-library docstrings from site-packages.

A copy of ``gfedntm_tpu/data/local_corpus.py`` (``clean_docstring``,
``DocstringCorpusConfig``, ``build_docstring_corpus``), kept here so the
port never imports the JAX package; it returns the port's
:class:`~gfedntm_tpu_torch.data.loaders.RawCorpus`. For the same tree and
seed it returns the same documents as the original
(``tests/test_torch_presets.py`` holds it to the original on synthetic
trees).

The JAX package's quality targets need a real-text federated corpus on a
host without network access; the installed Python libraries carry tens of
thousands of English docstrings (numpy/scipy math, torch deep learning,
RPC, NLP, data analysis), so this module assembles one from what is on the
machine. Federation shape: one client per PACKAGE FAMILY (math, deep
learning, cloud/RPC, NLP, data analysis) — a non-IID split in the same
sense as the reference's fieldsOfStudy partitioning of Semantic Scholar
(``docker-compose.yaml:21-149``: one client per research field).

Nothing here reads the network; the extractor only walks an installed
``site-packages`` tree with ``ast``.
"""

from __future__ import annotations

import ast
import hashlib
import os
import re
import sysconfig
from dataclasses import dataclass, field

from gfedntm_tpu_torch.data.loaders import RawCorpus

# One client per package family — the non-IID axis. Vendored subpackages
# (e.g. pip._vendor) are excluded by the top-level-name match.
DEFAULT_CLIENT_GROUPS: dict[str, tuple[str, ...]] = {
    "math": ("numpy", "scipy", "sympy", "networkx", "mpmath"),
    "deep_learning": ("torch", "tensorflow", "keras", "tf_keras", "flax",
                      "optax", "jax"),
    "cloud_rpc": ("google", "grpc", "proto", "googleapiclient", "vertexai"),
    "nlp": ("transformers", "nltk", "tokenizers", "datasets", "sentencepiece"),
    "data_analysis": ("sklearn", "pandas", "matplotlib", "statsmodels",
                      "PIL"),
}

_DOCTEST_RE = re.compile(r"^\s*(>>>|\.\.\.)")
_RST_ROLE_RE = re.compile(r":[a-zA-Z]+:`~?([^`]*)`")
_WORD_RE = re.compile(r"[a-z]{3,}")


def clean_docstring(text: str) -> list[str]:
    """Docstring -> lowercase alpha tokens: doctest lines and rst
    field-list markers dropped, rst roles unwrapped, identifiers split on
    underscores (``load_state_dict`` -> load state dict)."""
    lines = []
    for line in text.splitlines():
        if _DOCTEST_RE.match(line):
            continue
        stripped = line.strip()
        # rst field lists (:param x:, :returns:, Args:/Returns: headers)
        if stripped.startswith(":") or stripped.endswith("::"):
            continue
        lines.append(_RST_ROLE_RE.sub(r"\1", line))
    text = " ".join(lines).lower().replace("_", " ")
    return _WORD_RE.findall(text)


@dataclass
class DocstringCorpusConfig:
    site_packages: str | None = None  # default: the running interpreter's
    client_groups: dict[str, tuple[str, ...]] = field(
        default_factory=lambda: dict(DEFAULT_CLIENT_GROUPS)
    )
    min_words: int = 40       # raw docstring length gate (pre-clean)
    min_tokens: int = 25      # cleaned token gate
    docs_per_client: int = 3000
    seed: int = 0


def build_docstring_corpus(
    config: DocstringCorpusConfig | None = None,
) -> tuple[list[RawCorpus], dict]:
    """Extract, clean, dedup, and partition the docstring corpus.

    Returns ``(clients, info)``: one :class:`RawCorpus` per client group
    (documents are space-joined cleaned tokens, ready for the consensus /
    preprocessing pipeline) and an info dict with per-client counts.
    Deterministic for a fixed installation: files are walked in sorted
    order; the per-client cap keeps a seed-deterministic random subset
    (shuffled before capping so the kept docs aren't biased toward
    whichever subpackage sorts first).
    """
    import numpy as np

    config = config or DocstringCorpusConfig()
    root = config.site_packages or sysconfig.get_paths()["purelib"]
    top_to_client: dict[str, str] = {
        pkg: client
        for client, pkgs in config.client_groups.items()
        for pkg in pkgs
    }

    docs: dict[str, list[str]] = {c: [] for c in config.client_groups}
    seen: set[bytes] = set()
    scanned_files = 0
    for dirpath, dirnames, filenames in os.walk(root):
        # In-place pruning only works on the LIVE walk generator: sort for
        # determinism, drop __pycache__, and skip entire non-target
        # top-level packages (site-packages holds tens of thousands of
        # directories outside the client groups).
        rel = os.path.relpath(dirpath, root)
        if rel == ".":
            dirnames[:] = sorted(d for d in dirnames if d in top_to_client)
        else:
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        top = rel.split(os.sep)[0] if rel != "." else ""
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            if rel == ".":
                top = fn[:-3]
            client = top_to_client.get(top)
            if client is None:
                continue
            scanned_files += 1
            try:
                with open(
                    os.path.join(dirpath, fn), encoding="utf8",
                    errors="ignore",
                ) as f:
                    tree = ast.parse(f.read())
            except (SyntaxError, ValueError, OSError):
                continue
            for node in ast.walk(tree):
                if not isinstance(
                    node,
                    (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef,
                     ast.ClassDef),
                ):
                    continue
                ds = ast.get_docstring(node)
                if not ds or len(ds.split()) < config.min_words:
                    continue
                tokens = clean_docstring(ds)
                if len(tokens) < config.min_tokens:
                    continue
                digest = hashlib.blake2b(
                    " ".join(tokens).encode(), digest_size=16
                ).digest()
                if digest in seen:  # vendored/duplicated docstrings
                    continue
                seen.add(digest)
                docs[client].append(" ".join(tokens))

    # Balanced cap: a deterministic shuffle before capping so the kept
    # subset isn't biased toward whichever subpackage sorts first.
    rng = np.random.default_rng(config.seed)
    clients: list[RawCorpus] = []
    info: dict = {"site_packages": root, "per_client": {}, "scanned_files":
                  scanned_files}
    for client in config.client_groups:
        d = docs[client]
        order = rng.permutation(len(d))
        kept = [d[i] for i in order[: config.docs_per_client]]
        info["per_client"][client] = {
            "extracted": len(d), "kept": len(kept),
        }
        clients.append(RawCorpus(documents=kept))
    info["total_docs"] = sum(
        v["kept"] for v in info["per_client"].values()
    )
    return clients, info
