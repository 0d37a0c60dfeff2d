"""Atomic checkpoint files and numbered step checkpoints of train state.

Copies from ``gfedntm_tpu/train/checkpoint.py`` (:28-101, numpy and the
standard library only): :class:`CheckpointIntegrityError`, ``_fsync_dir``,
:func:`atomic_write_bytes`, :func:`atomic_write_json` and
``_load_sidecar_meta``. A write goes to a pid-suffixed temporary sibling,
is fsynced, renamed over its target and the directory fsynced, so a crash at
any point leaves the old complete file or the new one.

:class:`CheckpointManager` has the JAX class's interface (:104-142) over
torch files instead of orbax: one ``step_{n}.pt`` per step under one
directory, written atomically with ``torch.save`` and read back with
``torch.load(weights_only=True)``, so a checkpoint holds tensors, numbers,
strings and plain containers only. No reader in the port needs orbax's
layout. The server's ``FederationCheckpointer`` and ``RoundJournal`` are a
later slice.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import torch


class CheckpointIntegrityError(RuntimeError):
    """A federation checkpoint is unusable (truncated/corrupt sidecar JSON,
    or the sidecar and the checkpoint files disagree). Raised with an
    actionable message instead of a raw ``JSONDecodeError`` / ``KeyError``
    traceback."""


def _fsync_dir(path: str) -> None:
    """fsync the directory entry so a rename survives a power cut — on
    filesystems without O_DIRECTORY fsync (or exotic mounts) this is
    best-effort, the data-file fsync is the hard guarantee."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write(path: str, write) -> None:
    """``write(fh)`` into a temp sibling of ``path``, fsync it, then
    ``os.replace`` it over ``path`` and fsync the directory. The temp name
    is pid-suffixed so two processes racing the same target cannot corrupt
    each other's staging file; on failure it is removed and the target is
    untouched."""
    tmp = f"{path}.tmp.{os.getpid()}"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        with os.fdopen(fd, "wb") as fh:
            write(fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Crash-safe file replacement of ``path`` by ``data``."""
    _atomic_write(path, lambda fh: fh.write(data))


def atomic_write_json(path: str, obj: Any) -> None:
    atomic_write_bytes(path, json.dumps(obj).encode("utf-8"))


def _load_sidecar_meta(path: str, what: str, hint: str) -> dict[str, Any] | None:
    """Loader for the JSON halves of federation recovery state: ``None``
    when absent; corrupt JSON or missing required keys (``round``,
    ``average_keys``) raise :class:`CheckpointIntegrityError` carrying
    ``what``/``hint``."""
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        try:
            meta = json.load(fh)
        except json.JSONDecodeError as err:
            raise CheckpointIntegrityError(
                f"{what} {path} is truncated or corrupt ({err}); {hint}"
            ) from err
    missing = [k for k in ("round", "average_keys") if k not in meta]
    if missing:
        raise CheckpointIntegrityError(
            f"{what} {path} is missing required keys {missing}; {hint}"
        )
    return meta


_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _to_cpu(tree: Any) -> Any:
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _onto(target: Any, loaded: Any, path: str = "") -> Any:
    """``loaded`` with each tensor moved to the device of ``target``'s
    tensor at the same path, after checking that the two trees agree in
    keys, lengths, shapes and dtypes."""
    if torch.is_tensor(target):
        if not torch.is_tensor(loaded) or loaded.shape != target.shape \
                or loaded.dtype != target.dtype:
            raise CheckpointIntegrityError(
                f"checkpoint leaf {path or '<root>'}: {_describe(loaded)} does not match "
                f"{_describe(target)}")
        return loaded.to(target.device)
    if isinstance(target, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(target):
            raise CheckpointIntegrityError(
                f"checkpoint node {path or '<root>'}: keys "
                f"{sorted(map(str, loaded)) if isinstance(loaded, dict) else loaded!r} "
                f"!= {sorted(map(str, target))}")
        return {k: _onto(target[k], loaded[k], f"{path}/{k}") for k in target}
    if isinstance(target, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or len(loaded) != len(target):
            raise CheckpointIntegrityError(
                f"checkpoint node {path or '<root>'}: length does not match the target's "
                f"{len(target)}")
        return type(target)(_onto(t, v, f"{path}/{i}")
                            for i, (t, v) in enumerate(zip(target, loaded)))
    return loaded


def _describe(t: Any) -> str:
    if torch.is_tensor(t):
        return f"tensor {tuple(t.shape)} {t.dtype}"
    return type(t).__name__


class CheckpointManager:
    """Numbered step checkpoints under one directory, the newest
    ``max_to_keep`` kept. A step is written once: saving a step that is
    already on disk raises, as orbax does."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, state: Any, force: bool = False) -> None:
        """Write ``state`` (tensors moved to the CPU first) as ``step``.
        ``force`` is the JAX interface's: this manager has no save interval
        to override, so every call writes."""
        path = self._path(step)
        if os.path.exists(path):
            raise FileExistsError(f"checkpoint step {step} already exists: {path}")
        state = _to_cpu(state)
        _atomic_write(path, lambda fh: torch.save(state, fh))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.unlink(self._path(old))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for name in os.listdir(self.directory)
                      if (m := _STEP_FILE.match(name)))

    def restore(self, target: Any = None, step: int | None = None) -> Any:
        """The state saved as ``step`` (default: the latest). With a
        ``target`` (a live state tree), its structure, shapes and dtypes are
        checked against the file and each tensor lands on the device of the
        target's tensor; without one, every tensor stays on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        state = torch.load(self._path(step), map_location="cpu", weights_only=True)
        return state if target is None else _onto(target, state)

    def close(self) -> None:
        """Nothing to flush: every save is complete when it returns."""
