"""One federation client over several ranks (``Client(mesh_devices=N)``).

Counterpart of the JAX client's data mesh (``gfedntm_tpu/federation/client.py:485-492,
1109-1132``): the client's local step runs data-parallel over N ranks
(:class:`~gfedntm_tpu_torch.federated.stepper.FederatedStepper` with a data
layout), while the wire stays the one-device client's. Rank 0 is the
process that holds the gRPC face; ranks 1..N-1 are follower processes that
it starts itself (:class:`MeshRanks`, the ``spawn`` start method) as its
join begins, so their start-up overlaps the consensus, and stops when the
client finalizes.

- **Its own group.** The ranks form a process group on a store of their own
  (a ``FileStore`` in a fresh temporary directory): the client may live in
  a process that already has a default group (a rank program, a test), and
  its collectives must not touch that one. The collectives take the group
  as any process group (:mod:`~gfedntm_tpu_torch.parallel.collectives`).
- **What the followers get.** The model's configuration, its state after
  the server's GlobalSetup (network, optimizer, both generators) through a
  pipe, as plain pickle bytes (the pipe's own pickler would move each
  tensor into memory shared by both processes); their corpus as ``.npy`` files that each maps read-only and slices
  to its block of documents (nothing of the corpus is pickled); then every
  stepper call that changes state, in rank 0's order: ``pre_fit``, each
  step, each advance, each averaged set, stop. Every rank's state stays
  bitwise equal; :meth:`MeshStepper.rank_digests` reads it.
- **Followers die with rank 0.** A follower waits for its next command on
  its pipe, not in a collective, so rank 0 may sit idle between rounds for
  as long as the federation wants (and its reconnect loop may hold the
  servicer's lock) without a timeout. It polls the pipe once a second and
  exits when the pipe ends or rank 0 is gone. A follower caught in a step's
  collective when rank 0 dies sees the connection close, or at the latest
  the group's timeout (:data:`MESH_GROUP_TIMEOUT_S`), and exits.
- **No hidden failure.** A follower that raises sends its traceback up its
  pipe and exits; rank 0 raises it before its next command, or, when a
  step's collective fails first, with that error.

The layout: on the CPU, gloo with every rank on the CPU; on CUDA, NCCL with
one card per rank when the host has N cards, else gloo with every rank on
rank 0's card (``parallel/launch.gpu_layout``), which is logged, as the JAX
client logs a mesh smaller than asked.
"""

from __future__ import annotations

import datetime
import logging
import multiprocessing
import os
import pickle
import shutil
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

from gfedntm_tpu_torch.data.datasets import BowDataset, CTMDataset
from gfedntm_tpu_torch.federated.stepper import FederatedStepper, StepStatus
from gfedntm_tpu_torch.parallel.mesh import data_layout
from gfedntm_tpu_torch.train.checkpoint import to_cpu

#: Seconds a rank waits in one collective of a step before it gives up.
MESH_GROUP_TIMEOUT_S = 300.0
#: Seconds between a follower's checks that rank 0 is alive.
FOLLOWER_POLL_S = 1.0


def mesh_layout(device: torch.device, ranks: int,
                logger: logging.Logger | None = None) -> tuple[str, list[str]]:
    """``(backend, devices)`` of an N-rank mesh client whose rank 0 runs on
    ``device``: gloo on the CPU; on CUDA, NCCL with one card per rank from
    ``device`` on when the host has ``ranks`` cards, else gloo with every
    rank on ``device`` (logged)."""
    if device.type != "cuda":
        return "gloo", [str(device)] * ranks
    count = torch.cuda.device_count()
    if count >= ranks:
        base = device.index or 0
        return "nccl", [f"cuda:{(base + r) % count}" for r in range(ranks)]
    if logger is not None:
        logger.warning("mesh client asked for %d devices but only %d CUDA devices exist; its "
                       "%d ranks share %s over gloo", ranks, count, ranks, device)
    return "gloo", [str(device)] * ranks


def _group(backend: str, store_path: str, rank: int, ranks: int):
    store = dist.FileStore(store_path, ranks)
    timeout = datetime.timedelta(seconds=MESH_GROUP_TIMEOUT_S)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, ranks, opts)
    return dist.ProcessGroupGloo(store, rank, ranks, timeout)


def _digest(model) -> dict:
    from gfedntm_tpu_torch.parallel.programs import state_digest

    return state_digest({k: v.detach().cpu().numpy()
                         for k, v in model.model.state_dict().items()})


def _dataset_files(dataset: BowDataset, directory: str) -> dict:
    """Write the dataset's arrays as ``.npy`` files for the followers to map;
    returns ``{field: path}``."""
    files = {}
    for field in ("X", "X_ctx", "labels"):
        value = getattr(dataset, field, None)
        if value is not None:
            files[field] = os.path.join(directory, f"{field}.npy")
            np.save(files[field], np.asarray(value))
    return files


def _mapped_dataset(files: dict) -> BowDataset:
    arrays = {field: np.load(path, mmap_mode="r") for field, path in files.items()}
    if "X_ctx" in arrays:
        return CTMDataset(X=arrays["X"], X_ctx=arrays["X_ctx"], labels=arrays.get("labels"))
    return BowDataset(X=arrays["X"])


def _alive_parent() -> bool:
    parent = multiprocessing.parent_process()
    return parent is None or parent.is_alive()


def _follower_main(rank: int, ranks: int, backend: str, device: str, store_path: str,
                   conn) -> None:
    """A follower rank: warm up (imports, the CUDA context) while rank 0
    waits for its GlobalSetup, join the client's group with the setup,
    build the stepper from it, then run rank 0's commands until ``stop``,
    the pipe's end or rank 0's death."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.zeros(1, device=dev)
        else:
            torch.set_num_threads(1)  # N ranks on one host: no oversubscription
        from gfedntm_tpu_torch.federation.server import build_template_model  # noqa: F401

        stepper = None
        while True:
            if not conn.poll(FOLLOWER_POLL_S):
                if not _alive_parent():
                    return
                continue
            try:
                cmd, *args = pickle.loads(conn.recv_bytes())
            except EOFError:
                return
            if cmd == "stop":
                return
            if cmd == "setup":
                group = _group(backend, store_path, rank, ranks)
                stepper = _build_follower(dev, group, rank, ranks, *args)
            elif cmd == "pre_fit":
                stepper.pre_fit(_mapped_dataset(args[0]))
            elif cmd == "train":
                stepper.train_mb_delta(snapshot=False)
            elif cmd == "advance":
                stepper.advance_local()
            elif cmd == "update":
                stepper.delta_update_fit(args[0])
            elif cmd == "set":
                stepper.set_gradients(args[0])
            elif cmd == "digest":
                conn.send(("digest", _digest(stepper.model)))
            else:
                raise ValueError(f"unknown mesh command {cmd!r}")
    except Exception:  # reported to rank 0, which raises it
        try:
            conn.send(("error", f"mesh rank {rank}:\n{traceback.format_exc()}"))
        except (BrokenPipeError, OSError):
            pass
        raise SystemExit(1) from None


def _build_follower(dev, group, rank: int, ranks: int, setup: dict) -> FederatedStepper:
    from gfedntm_tpu_torch.federation.server import build_template_model

    model = build_template_model(setup["family"], setup["vocab_size"], setup["kwargs"],
                                 device=dev)
    model.model.load_state_dict(setup["state"])
    model.optimizer.load_state_dict(setup["optimizer"])
    model.generator.set_state(setup["generator"])
    model._np_rng.bit_generator.state = setup["np_rng"]
    return FederatedStepper(model, grads_to_share=setup["grads_to_share"],
                            mesh=data_layout(ranks, group, rank))


class MeshRanks:
    """A mesh client's follower processes, started on ``device``'s layout
    (:func:`mesh_layout`) as soon as the client knows it wants them, so
    their imports and CUDA contexts overlap its join; the group forms when
    :meth:`setup` hands them the model. ``close`` stops them."""

    def __init__(self, device: torch.device, ranks: int, logger: logging.Logger | None = None):
        if ranks < 2:
            raise ValueError(f"a mesh client needs at least 2 ranks, got {ranks}")
        self.ranks = ranks
        self.backend, self.devices = mesh_layout(device, ranks, logger)
        self.group = None
        self._dir = tempfile.mkdtemp(prefix="gfedntm_mesh_")
        self._store = os.path.join(self._dir, "store")
        ctx = multiprocessing.get_context("spawn")
        self.conns, self.procs = [], []
        try:
            for rank in range(1, ranks):
                here, there = ctx.Pipe()
                proc = ctx.Process(target=_follower_main, daemon=True, args=(
                    rank, ranks, self.backend, self.devices[rank], self._store, there))
                proc.start()
                there.close()
                self.conns.append(here)
                self.procs.append(proc)
        except BaseException:
            self.close()
            raise

    def setup(self, model, family: str, vocab_size: int, model_kwargs: dict,
              grads_to_share) -> None:
        """Send the followers ``model``'s configuration and state, and form
        the group."""
        self.send("setup", {
            "family": family, "vocab_size": int(vocab_size), "kwargs": dict(model_kwargs),
            "state": to_cpu(model.model.state_dict()),
            "optimizer": to_cpu(model.optimizer.state_dict()),
            "generator": model.generator.get_state(),
            "np_rng": model._np_rng.bit_generator.state,
            "grads_to_share": tuple(grads_to_share),
        })
        self.group = _group(self.backend, self._store, 0, self.ranks)

    def check(self) -> None:
        """Raise when a follower has failed (its traceback, or its exit)."""
        for rank, (conn, proc) in enumerate(zip(self.conns, self.procs), start=1):
            if conn.poll(0):
                kind, payload = conn.recv()
                if kind == "error":
                    raise RuntimeError(payload)
            if not proc.is_alive():
                raise RuntimeError(f"mesh rank {rank} exited with code {proc.exitcode}")

    def send(self, cmd: str, *args) -> None:
        self.check()
        # Plain pickle bytes: the pipe's own pickler would move every tensor
        # into memory shared with the follower, where both ranks would then
        # update the same optimizer state.
        payload = pickle.dumps((cmd, *args), protocol=pickle.HIGHEST_PROTOCOL)
        for conn in self.conns:
            conn.send_bytes(payload)

    def digests(self) -> list[dict]:
        """Every follower's state digest, in rank order."""
        self.send("digest")
        out = []
        for rank, conn in enumerate(self.conns, start=1):
            kind, payload = conn.recv()
            if kind != "digest":
                raise RuntimeError(payload if kind == "error" else f"mesh rank {rank}: {kind}")
            out.append(payload)
        return out

    def dataset_files(self, dataset: BowDataset) -> dict:
        return _dataset_files(dataset, self._dir)

    def close(self, timeout: float = 10.0) -> None:
        """Stop the followers (killed when they do not exit within
        ``timeout``) and remove the client's store and corpus files."""
        stop = pickle.dumps(("stop",))
        for conn in self.conns:
            try:
                conn.send_bytes(stop)
            except (BrokenPipeError, OSError):
                pass
        for proc in self.procs:
            proc.join(timeout)
            if proc.is_alive():
                proc.kill()
                proc.join(5.0)
        for conn in self.conns:
            conn.close()
        self.conns, self.procs = [], []
        shutil.rmtree(self._dir, ignore_errors=True)


class MeshStepper(FederatedStepper):
    """Rank 0 of a client's data-parallel stepper: a
    :class:`FederatedStepper` over an N-rank data layout whose follower
    ranks (:class:`MeshRanks`, started here when ``ranks`` is a count) run
    the same calls (module docstring). Every call that changes state goes
    to the followers first, then runs here; what reads state (snapshots,
    accounting, results) reads rank 0's, which every rank shares.

    ``family``, ``vocab_size`` and ``model_kwargs`` rebuild ``model`` in the
    followers (``federation.server.build_template_model``); its current
    state, optimizer state and generators go along."""

    def __init__(self, model, ranks: "int | MeshRanks", family: str, vocab_size: int,
                 model_kwargs: dict, grads_to_share, epoch_snapshot_dir: str | None = None,
                 metrics=None, logger: logging.Logger | None = None):
        self.logger = logger or logging.getLogger("MeshStepper")
        self.mesh_ranks = (ranks if isinstance(ranks, MeshRanks)
                           else MeshRanks(model.device, ranks, self.logger))
        self.ranks = self.mesh_ranks.ranks
        self._sending = True
        try:
            self.mesh_ranks.setup(model, family, vocab_size, model_kwargs, grads_to_share)
            super().__init__(model, grads_to_share=grads_to_share,
                             epoch_snapshot_dir=epoch_snapshot_dir, metrics=metrics,
                             mesh=data_layout(self.ranks, self.mesh_ranks.group, 0))
        except BaseException:
            self.close()
            raise
        self.logger.info("mesh client: %d ranks over %s on %s", self.ranks,
                         self.mesh_ranks.backend, self.mesh_ranks.devices)

    def _step(self, fn, *args):
        """Run rank 0's part of a collective step; on failure, raise a
        follower's own error when it has one."""
        try:
            return fn(*args)
        except Exception:
            self.mesh_ranks.check()
            raise

    def rank_digests(self) -> list[dict]:
        """Every rank's state digest (dtype, shape and SHA-256 per entry),
        rank 0's first: equal digests are bitwise equal states."""
        return [_digest(self.model), *self.mesh_ranks.digests()]

    def close(self, timeout: float = 10.0) -> None:
        """Stop the followers and remove their files."""
        self.mesh_ranks.close(timeout)

    # ---- the stepper calls that change state ---------------------------------
    def pre_fit(self, train_dataset: BowDataset) -> None:
        self.mesh_ranks.send("pre_fit", self.mesh_ranks.dataset_files(train_dataset))
        super().pre_fit(train_dataset)

    def train_mb_delta(self, snapshot: bool = True) -> dict[str, np.ndarray]:
        self.mesh_ranks.send("train")
        return self._step(super().train_mb_delta, snapshot)

    def advance_local(self) -> StepStatus:
        self.mesh_ranks.send("advance")
        return super().advance_local()

    def delta_update_fit(self, averaged: dict[str, np.ndarray]) -> StepStatus:
        self.mesh_ranks.send("update", averaged)
        self._sending = False  # the followers' own update sets the average
        try:
            return super().delta_update_fit(averaged)
        finally:
            self._sending = True

    def set_gradients(self, averaged: dict[str, np.ndarray]) -> None:
        if self._sending:
            self.mesh_ranks.send("set", averaged)
        super().set_gradients(averaged)

