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
layout.

:class:`FederationCheckpointer` and :class:`RoundJournal` are the network
server's round state (``gfedntm_tpu/train/checkpoint.py:148-460``).
The journal is a copy: a flat npz of the broadcast average (in the JAX
layout on both sides) and the aggregator slots, and a JSON record, so the
port and the JAX package each read the other's journal bitwise. The
checkpointer keeps the ``federation.json`` sidecar and
``aggregator_state.npz`` byte-compatible and writes its rounds through
:class:`CheckpointManager` (``rounds/step_{n}.pt``) instead of orbax; a
sidecar whose rounds are orbax directories (a JAX server's) raises
:class:`CheckpointIntegrityError` with a hint rather than being half read.
"""

from __future__ import annotations

import io
import json
import logging
import os
import re
from typing import Any

import numpy as np
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


def to_cpu(tree: Any) -> Any:
    """``tree`` (dicts, lists and tuples of tensors and other leaves) with
    every tensor detached and on the CPU (a CPU tensor is not copied)."""
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
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
        state = to_cpu(state)
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


class FederationCheckpointer:
    """Round-state checkpoints for the network federation server.

    The numeric state — the shared-subset ``last_average`` — rides the
    torch :class:`CheckpointManager` under ``rounds/`` (as a list of
    tensors, the key order pinned in the JSON sidecar, as the JAX class
    does for orbax). The consensus vocabulary, the sorted average keys and
    the membership snapshot live in an atomically-replaced
    ``federation.json`` next to the round files, in the JAX package's
    format. The manager's ``latest_step`` is the authoritative resume
    round; the sidecar is
    rewritten after each array save, and :meth:`restore_round` verifies the
    two agree — after a crash between the writes it falls back (loudly) to
    the round the sidecar describes when that round is still on disk,
    while a corrupt/truncated sidecar or an unreconcilable mismatch
    surfaces as :class:`CheckpointIntegrityError` with a recovery hint,
    never as a raw traceback mid ``--resume``.
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._mgr = CheckpointManager(
            os.path.join(self.directory, "rounds"), max_to_keep=max_to_keep
        )
        self.meta_path = os.path.join(self.directory, "federation.json")
        self.aggregator_path = os.path.join(
            self.directory, "aggregator_state.npz"
        )

    def save_round(
        self,
        round_idx: int,
        average: dict[str, np.ndarray],
        membership: list[dict[str, Any]],
        vocab: list[str] | None = None,
        extra: dict[str, Any] | None = None,
        aggregator_state: dict[str, np.ndarray] | None = None,
    ) -> None:
        keys = sorted(average)
        # Idempotent per round: the server's final checkpoint can land on
        # the same round as the last periodic one (the manager raises
        # on a re-save, as orbax does), and
        # a given round's state is the same state.
        if self._mgr.latest_step() == int(round_idx):
            return
        self._mgr.save(
            int(round_idx),
            [torch.from_numpy(np.array(average[k], copy=True)) for k in keys],
            force=True,
        )
        # Server-aggregator optimizer state (FedAvgM/FedAdam momenta — a
        # flat npz-able array dict, see aggregation.ServerAggregator):
        # saved NEXT TO the round files, tagged with its round so a crash
        # between the two writes is detected at restore instead of pairing
        # round-R parameters with round-R' moments.
        if aggregator_state:
            atomic_write_bytes(
                self.aggregator_path,
                _npz_bytes(aggregator_state, round_idx),
            )
        elif os.path.exists(self.aggregator_path):
            # Stateless aggregator now: a stale state file from an earlier
            # configuration must not survive to poison a later resume.
            os.remove(self.aggregator_path)
        meta = {
            "round": int(round_idx),
            "average_keys": keys,
            "membership": membership,
            **(extra or {}),
        }
        if vocab is not None:
            meta["vocab"] = list(vocab)
        atomic_write_json(self.meta_path, meta)

    def load_aggregator_state(
        self,
    ) -> "tuple[int, dict[str, np.ndarray]] | None":
        """The ``(round, arrays)`` saved by the last :meth:`save_round`, or
        ``None`` when the aggregator was stateless (no file)."""
        if not os.path.exists(self.aggregator_path):
            return None
        try:
            with np.load(self.aggregator_path) as data:
                arrays = {k: data[k] for k in data.files if k != "__round__"}
                return int(data["__round__"]), arrays
        except (OSError, ValueError, KeyError) as err:
            raise CheckpointIntegrityError(
                f"aggregator state {self.aggregator_path} is corrupt "
                f"({err}); delete it to restart the server optimizer cold"
            ) from err

    def latest_round(self) -> int | None:
        step = self._mgr.latest_step()
        if step is None:
            self._refuse_foreign_rounds()
        return step

    def _refuse_foreign_rounds(self) -> None:
        """Round directories without step files are orbax rounds, written
        by the JAX package's checkpointer: say so instead of reading the
        sidecar's half of a state whose arrays this manager cannot load."""
        rounds = self._mgr.directory
        foreign = sorted(name for name in os.listdir(rounds)
                         if name.isdigit() and os.path.isdir(os.path.join(rounds, name)))
        if foreign:
            raise CheckpointIntegrityError(
                f"{rounds} holds orbax round directories {foreign[-3:]} (a "
                "gfedntm_tpu server's checkpoints) and no round files of this "
                "package; resume that run with the gfedntm_tpu server, recover "
                "it from its round journal (journal.json + journal_state.npz, "
                "which both packages read), or delete the checkpoint directory "
                f"{self.directory} to start fresh"
            )

    def load_meta(self) -> dict[str, Any] | None:
        """The sidecar metadata, or ``None`` when absent. A sidecar that
        exists but cannot be parsed (truncated write, disk corruption) or
        lacks its required keys raises :class:`CheckpointIntegrityError`
        with a recovery hint rather than a raw traceback."""
        return _load_sidecar_meta(
            self.meta_path, "federation sidecar",
            f"restore it from a backup, or delete the checkpoint "
            f"directory {self.directory} to start the federation fresh",
        )

    def restore_round(
        self, template: dict[str, np.ndarray], step: int | None = None
    ) -> tuple[int, dict[str, np.ndarray]]:
        """Restore ``(round_idx, average)``; ``template`` supplies the
        expected key set and array shapes (e.g. the shared flat subset of a
        freshly built template model)."""
        meta = self.load_meta()
        if meta is None:
            raise FileNotFoundError(f"no federation meta at {self.meta_path}")
        keys = meta["average_keys"]
        missing = [k for k in keys if k not in template]
        if missing:
            raise ValueError(
                f"checkpoint avg keys not in template (model config "
                f"changed since the checkpoint?): {missing[:3]}"
            )
        explicit_step = step is not None
        step = self.latest_round() if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no round checkpoint under {self.directory}"
            )
        meta_round = int(meta["round"])
        if not explicit_step and meta_round != int(step):
            # The two halves are written rounds-first, sidecar-second, so a
            # crash between the writes leaves the sidecar one checkpoint
            # behind the newest round. The round the sidecar DOES
            # describe is usually still on disk (max_to_keep > 1): resume
            # from it — loudly — instead of pairing round-R arrays with
            # round-R' metadata or demanding manual surgery.
            if meta_round in self._mgr.all_steps():
                logging.getLogger("FederationCheckpointer").warning(
                    "checkpoint sidecar describes round %d but the newest "
                    "saved round is %d (crash between the two writes?); "
                    "resuming from round %d, whose halves agree",
                    meta_round, int(step), meta_round,
                )
                step = meta_round
            else:
                raise CheckpointIntegrityError(
                    f"checkpoint round mismatch under {self.directory}: "
                    f"the saved rounds are {self._mgr.all_steps()} but "
                    f"the sidecar {self.meta_path} describes round "
                    f"{meta_round}, which is not among them (mixed runs "
                    "or corruption); delete the checkpoint directory to "
                    "start fresh"
                )
        arrays = self._mgr.restore(step=step)
        if not isinstance(arrays, list) or len(arrays) != len(keys):
            raise CheckpointIntegrityError(
                f"round {step} under {self.directory} does not hold the "
                f"{len(keys)} arrays its sidecar declares; delete the "
                "checkpoint directory to start fresh"
            )
        restored = {}
        for key, arr in zip(keys, arrays):
            want = np.asarray(template[key])
            if tuple(arr.shape) != want.shape:
                raise CheckpointIntegrityError(
                    f"round {step} array {key!r} has shape {tuple(arr.shape)}, "
                    f"the template {want.shape}"
                )
            # Restored in the template's dtype, as orbax restores into its
            # target's (a float64 average of int counters comes back int).
            restored[key] = arr.numpy().astype(want.dtype, copy=False)
        return int(step), restored

    def close(self) -> None:
        self._mgr.close()


def _npz_bytes(arrays: dict[str, np.ndarray], round_idx: int) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, __round__=np.int64(round_idx), **arrays)
    return buf.getvalue()


#: npz key prefix separating journaled aggregator slots from average keys.
_AGG_PREFIX = "__agg__/"


class RoundJournal:
    """Per-round crash-recovery journal for the federation server.

    The :class:`FederationCheckpointer` is the *rollback-quality*
    store: guardian-gated, written every ``checkpoint_every`` rounds, the
    target a divergence rollback restores. This journal is the *crash
    recovery* store: one cheap atomic write per pushed round (a flat npz
    of the broadcast average + aggregator slots, and a JSON record of the
    round, key order, membership — session tokens included — and
    consensus vocabulary), so a SIGKILLed server restarted with NO
    operator flags resumes from the last fully-pushed round and replays
    at most the one round that was in flight at the kill.

    Both files go through :func:`atomic_write_bytes` (temp + fsync +
    ``os.replace`` + directory fsync): a kill mid-write can never produce
    a truncated journal. The npz is written first, the JSON second; the
    JSON's ``round`` must match the npz's ``__round__`` tag, so a kill
    between the two writes is detected at load (the stale JSON describes
    the previous round whose npz was just overwritten) and reported as
    :class:`CheckpointIntegrityError` — the caller degrades to the round
    checkpoint.
    """

    STATE_NAME = "journal_state.npz"
    META_NAME = "journal.json"

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.state_path = os.path.join(self.directory, self.STATE_NAME)
        self.meta_path = os.path.join(self.directory, self.META_NAME)

    def record(
        self,
        round_idx: int,
        average: dict[str, np.ndarray],
        membership: list[dict[str, Any]],
        vocab: list[str] | None = None,
        extra: dict[str, Any] | None = None,
        aggregator_state: dict[str, np.ndarray] | None = None,
    ) -> None:
        """Journal one fully-pushed round (arrays first, meta second)."""
        keys = sorted(average)
        arrays = {k: np.asarray(average[k]) for k in keys}
        for name, arr in (aggregator_state or {}).items():
            arrays[_AGG_PREFIX + name] = np.asarray(arr)
        atomic_write_bytes(self.state_path, _npz_bytes(arrays, round_idx))
        meta = {
            "round": int(round_idx),
            "average_keys": keys,
            "membership": membership,
            **(extra or {}),
        }
        if vocab is not None:
            meta["vocab"] = list(vocab)
        atomic_write_json(self.meta_path, meta)

    def mark_finished(self) -> None:
        """Stamp the journal after a normal stop broadcast: a finished
        federation must not be resurrected by the next server start's
        auto-recovery probe."""
        meta = None
        try:
            meta = self.load_meta()
        except CheckpointIntegrityError:
            meta = None
        if meta is None:
            meta = {"round": -1, "average_keys": [], "membership": []}
        meta["finished"] = True
        atomic_write_json(self.meta_path, meta)

    def load_meta(self) -> dict[str, Any] | None:
        """The journal's JSON record, or ``None`` when absent; corrupt or
        key-incomplete JSON raises :class:`CheckpointIntegrityError` with
        a recovery hint (same contract as the checkpoint sidecar)."""
        return _load_sidecar_meta(
            self.meta_path, "round journal",
            "delete it to fall back to the latest round checkpoint",
        )

    def load(self, include_finished: bool = False) -> "dict[str, Any] | None":
        """Load the journaled round: a dict with ``round``, ``average``,
        ``aggregator_state``, ``membership``, ``vocab``, and every extra
        key the writer recorded — or ``None`` when no journal exists (or
        it is marked finished — ``include_finished=True`` loads it
        anyway: the SERVING plane wants a cleanly-finished run's final
        model, which only auto-recovery must never resurrect). Integrity
        failures (corrupt JSON/npz, or a round tag disagreement from a
        kill between the two writes) raise
        :class:`CheckpointIntegrityError`."""
        meta = self.load_meta()
        if meta is None or (meta.get("finished") and not include_finished):
            return None
        if not os.path.exists(self.state_path):
            raise CheckpointIntegrityError(
                f"round journal {self.meta_path} describes round "
                f"{meta['round']} but {self.state_path} is missing; "
                "delete the journal to fall back to the latest checkpoint"
            )
        try:
            with np.load(self.state_path) as data:
                state_round = int(data["__round__"])
                arrays = {
                    k: np.asarray(data[k])
                    for k in data.files if k != "__round__"
                }
        except (OSError, ValueError, KeyError, EOFError) as err:
            raise CheckpointIntegrityError(
                f"round journal state {self.state_path} is corrupt "
                f"({err}); delete the journal to fall back to the latest "
                "checkpoint"
            ) from err
        if state_round != int(meta["round"]):
            raise CheckpointIntegrityError(
                f"round journal halves disagree under {self.directory}: "
                f"meta describes round {meta['round']} but the state file "
                f"is round {state_round} (kill between the two writes); "
                "delete the journal to fall back to the latest checkpoint"
            )
        average: dict[str, np.ndarray] = {}
        agg_state: dict[str, np.ndarray] = {}
        for key, arr in arrays.items():
            if key.startswith(_AGG_PREFIX):
                agg_state[key[len(_AGG_PREFIX):]] = arr
            else:
                average[key] = arr
        missing = [k for k in meta["average_keys"] if k not in average]
        if missing:
            raise CheckpointIntegrityError(
                f"round journal state {self.state_path} lacks average "
                f"keys {missing[:3]} its meta declares; delete the "
                "journal to fall back to the latest checkpoint"
            )
        out = dict(meta)
        out["round"] = state_round
        out["average"] = average
        out["aggregator_state"] = agg_state
        return out
