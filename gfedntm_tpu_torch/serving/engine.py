"""Hot-swappable doc→topic inference engine.

Counterpart of ``gfedntm_tpu/serving/engine.py``. It loads published global
models from the store a federation server writes (the port's
:class:`~gfedntm_tpu_torch.train.checkpoint.RoundJournal` and
:class:`~gfedntm_tpu_torch.train.checkpoint.FederationCheckpointer`, with
the server's prefer-newer rule), runs the encoder-only doc→θ path
(:meth:`DecoderNetwork.get_theta` with ``noise=0`` — the deterministic
posterior-mean θ, eval-mode BatchNorm, no dropout, no decoder matmul, so
none of the fused decode kernels), and swaps models atomically as the
federation publishes new rounds, without dropping in-flight requests.

:class:`PublishedModel`, :class:`ModelSource` and :func:`default_buckets`
are the JAX package's (``engine.py:56-285``) over the port's store. A JAX
server's journal is served as it is; a JAX store whose newest round is an
orbax checkpoint raises the port checkpointer's
:class:`~gfedntm_tpu_torch.train.checkpoint.CheckpointIntegrityError`.

Design points:

- **Bucketed padding**: request batches are padded with all-zero rows up to
  a small set of power-of-two bucket sizes, so the steady state runs a
  handful of shapes. Eval-mode BatchNorm uses running statistics, so the
  padded rows cannot perturb the real ones; they are sliced off before
  return.
- **One module per slot.** A torch module holds its weights, where a flax
  module is a frozen config beside immutable arrays, so the JAX engine's
  reuse of the installed module (``engine.py:489-498``) would write the
  new round into the model that in-flight requests are reading. Each slot
  owns its module: a ``copy.deepcopy`` of the installed one when the model
  identity is unchanged, else a freshly built template. The installed slot
  is never written to. Serving modules are put in eval mode once and never
  toggled (``get_theta`` toggles the mode; the engine computes its
  ``noise=0`` θ with the same operations and no toggle).
- **Atomic hot-swap**: a published round is loaded and **warmed through
  every bucket** off to the side, the device synchronized, then installed
  by a single attribute rebind. In-flight requests snapshot the slot once
  at batch time.
- **Quality gate**: a candidate whose journaled ``quality`` record says the
  coherence guard had a live unhealthy streak (``quality.flagged``) is
  refused — the plane keeps serving the last good model and emits a
  ``serve_swap_refused`` event + counter.

The JAX engine's input donation and ``timed_jit`` are XLA's; the port runs
eager PyTorch and has neither (``donate`` is accepted and has no effect).
After a swap the device-memory gauges are the ones the port's stepper sets
(``device_bytes_in_use/cudaN``, ``device_peak_bytes_in_use/cudaN``).
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import threading
from typing import Any, Mapping

import numpy as np
import torch

from gfedntm_tpu_torch import interop
from gfedntm_tpu_torch.device import resolve_device

__all__ = [
    "PublishedModel",
    "ModelSource",
    "ServingEngine",
    "default_buckets",
]


@dataclasses.dataclass
class PublishedModel:
    """One published global model, as read from the recovery store."""

    round: int
    source: str  # "journal" | "checkpoint"
    vocab: tuple[str, ...]
    family: str
    model_kwargs: dict[str, Any]
    average: dict[str, np.ndarray]
    quality: dict[str, Any] | None = None

    @property
    def flagged(self) -> bool:
        """True when the coherence guard had a live unhealthy streak at
        the time this round was journaled — the serving plane must not
        swap it in."""
        return bool((self.quality or {}).get("flagged"))


class ModelSource:
    """Read-side twin of ``FederatedServer.restore_from_checkpoint``:
    watches a federation ``save_dir`` for newly published rounds and
    loads the newest of the round journal and the round checkpoint.

    ``family``/``model_kwargs`` are fallbacks for recovery state written
    before the journal became self-describing; newer state carries both
    in its ``extra`` record and wins. :meth:`peek` reads only the two
    JSON halves (cheap enough for a poll loop); :meth:`load` pays the
    array read.
    """

    def __init__(
        self,
        save_dir: str,
        family: str = "avitm",
        model_kwargs: dict[str, Any] | None = None,
        logger: logging.Logger | None = None,
        metrics=None,
    ):
        import os

        self.directory = os.path.join(os.path.abspath(save_dir), "checkpoints")
        self.family = family
        self.model_kwargs = dict(model_kwargs or {})
        self.logger = logger or logging.getLogger("ModelSource")
        self.metrics = metrics
        # Both stores are constructed lazily AND only once the directory
        # exists: this is a pure READER — RoundJournal/
        # FederationCheckpointer.__init__ would mkdir the store, and a
        # serve role pointed at a typo'd save_dir must keep polling an
        # absent store (ready stays 503), not plant an empty one there.
        self._journal = None
        self._ckpt = None

    def _store_exists(self) -> bool:
        import os

        return os.path.isdir(self.directory)

    def _journal_obj(self):
        if self._journal is None and self._store_exists():
            from gfedntm_tpu_torch.train.checkpoint import RoundJournal

            self._journal = RoundJournal(self.directory)
        return self._journal

    def _checkpointer(self):
        if self._ckpt is None and self._store_exists():
            from gfedntm_tpu_torch.train.checkpoint import FederationCheckpointer

            self._ckpt = FederationCheckpointer(self.directory)
        return self._ckpt

    def _journal_meta(self) -> dict[str, Any] | None:
        """Journal JSON half, or None; corruption is loud but demotes to
        the checkpoint (the server's own degradation rule)."""
        from gfedntm_tpu_torch.train.checkpoint import CheckpointIntegrityError

        journal = self._journal_obj()
        if journal is None:
            return None
        try:
            meta = journal.load_meta()
        except CheckpointIntegrityError as err:
            self.logger.error("round journal unusable for serving: %s", err)
            if self.metrics is not None:
                self.metrics.registry.counter("serving_source_errors").inc()
            return None
        # A finished journal still describes a perfectly servable model —
        # recovery must not resurrect it, but serving it is the point.
        return meta

    def peek(self) -> tuple[int, str] | None:
        """Newest published ``(model_round, source)`` without touching
        arrays, or ``None`` when nothing is published yet. Both sources
        are reported on the JOURNAL's scale — the round the model was
        averaged at: the journal records the last fully-pushed round R
        directly, while the checkpoint sidecar's ``round`` is the RESUME
        round (the round training continues FROM), i.e. model round + 1,
        so it is normalized down by one. Mixing the two scales would
        both mislabel ``model_round`` in replies and make ``publish``
        refuse a journal round strictly newer than a checkpoint-sourced
        slot. Same prefer-newer rule as ``restore_from_checkpoint``."""
        from gfedntm_tpu_torch.train.checkpoint import CheckpointIntegrityError

        jmeta = self._journal_meta()
        j_round = int(jmeta["round"]) if jmeta is not None else None
        if j_round is not None and j_round < 0:
            j_round = None  # finished-stamp placeholder, no arrays
        ckpt = self._checkpointer()
        try:
            cmeta = ckpt.load_meta() if ckpt is not None else None
        except CheckpointIntegrityError as err:
            self.logger.error("checkpoint unusable for serving: %s", err)
            cmeta = None
        c_model = (
            max(int(cmeta["round"]) - 1, 0) if cmeta is not None else None
        )
        if j_round is None and c_model is None:
            return None
        if c_model is None or (j_round is not None and j_round >= c_model):
            return (j_round, "journal")
        return (c_model, "checkpoint")

    def load(self) -> PublishedModel | None:
        """Load the newest published model (arrays included), or ``None``
        when nothing is published. Integrity failures degrade journal →
        checkpoint and raise only when neither half is usable."""
        from gfedntm_tpu_torch.train.checkpoint import CheckpointIntegrityError

        newest = self.peek()
        if newest is None:
            return None
        _round, source = newest
        if source == "journal":
            try:
                jstate = self._journal_obj().load(include_finished=True)
            except CheckpointIntegrityError as err:
                # For a LIVE reader a halves-disagreement is usually the
                # server mid-write (npz lands before the JSON) — the next
                # poll self-heals. Degrade to the checkpoint quietly but
                # visibly (counter); the server-side recovery path is the
                # one that treats this state as corruption.
                self.logger.info(
                    "journal not readable this poll (%s); degrading to "
                    "the checkpoint and retrying next poll", err,
                )
                if self.metrics is not None:
                    self.metrics.registry.counter(
                        "serving_source_retries"
                    ).inc()
                jstate = None
            if jstate is not None:
                return self._published_from_meta(
                    int(jstate["round"]), "journal", jstate,
                    jstate["average"],
                )
        return self._load_checkpoint()

    def _load_checkpoint(self) -> PublishedModel | None:
        from gfedntm_tpu_torch.train.checkpoint import CheckpointIntegrityError

        ckpt = self._checkpointer()
        if ckpt is None:
            return None
        try:
            meta = ckpt.load_meta()
        except CheckpointIntegrityError:
            meta = None
        # latest_round() refuses a JAX store's orbax rounds, loudly.
        if meta is None or ckpt.latest_round() is None:
            return None
        vocab, family, kwargs = self._model_identity(meta)
        template = _flat_template(family, vocab, kwargs)
        try:
            round_idx, average = ckpt.restore_round(template)
        except (CheckpointIntegrityError, FileNotFoundError) as err:
            self.logger.error("checkpoint restore failed for serving: %s", err)
            if self.metrics is not None:
                self.metrics.registry.counter("serving_source_errors").inc()
            return None
        # Normalize the sidecar's RESUME-round label to the model-round
        # scale the journal (and every reply/gauge) uses — see peek().
        return self._published_from_meta(
            max(int(round_idx) - 1, 0), "checkpoint", meta, average
        )

    def _model_identity(
        self, meta: Mapping[str, Any]
    ) -> tuple[tuple[str, ...], str, dict[str, Any]]:
        vocab = tuple(meta.get("vocab") or ())
        if not vocab:
            raise ValueError(
                f"recovery state under {self.directory} has no consensus "
                "vocabulary; the serving plane cannot rebuild the model"
            )
        family = meta.get("family") or self.family
        kwargs = dict(meta.get("model_kwargs") or self.model_kwargs)
        if not kwargs:
            raise ValueError(
                "recovery state predates self-describing journals and no "
                "model_kwargs were configured; pass the training model "
                "config to the serve role"
            )
        return vocab, family, kwargs

    def _published_from_meta(
        self, round_idx: int, source: str, meta: Mapping[str, Any],
        average: dict[str, np.ndarray],
    ) -> PublishedModel:
        vocab, family, kwargs = self._model_identity(meta)
        quality = meta.get("quality")
        return PublishedModel(
            round=int(round_idx), source=source, vocab=vocab,
            family=family, model_kwargs=kwargs,
            average={k: np.asarray(v) for k, v in average.items()},
            quality=dict(quality) if isinstance(quality, dict) else None,
        )


def default_buckets(max_batch: int) -> tuple[int, ...]:
    """Power-of-two bucket sizes up to (and including) ``max_batch`` —
    the padded batch shapes the engine runs."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return tuple(out)


def _flat_names(state: Mapping[str, Any]) -> dict[str, str]:
    """``{"params/..." | "batch_stats/...": key}`` over a state dict's keys:
    the journal's flax names (:func:`gfedntm_tpu_torch.interop.flax_path`)."""
    return {"/".join((collection, *path)): key
            for key in state for collection, path in [interop.flax_path(key)]}


def _flat_variables(module: torch.nn.Module) -> dict[str, np.ndarray]:
    """``module``'s state as flax-named host arrays (the journal's layout)."""
    state = module.state_dict()
    return {name: interop.to_flax(key, state[key]) for name, key in _flat_names(state).items()}


def _flat_template(
    family: str, vocab: tuple[str, ...], model_kwargs: dict[str, Any],
    device="cpu",
):
    """Flat ``key -> np.ndarray`` view of a freshly built template model's
    variables — the restore target for checkpoint rounds (covers every
    possible ``average_keys`` subset; only its keys, shapes and dtypes
    are read, so it is built on the CPU)."""
    from gfedntm_tpu_torch.federation.server import build_template_model

    model = build_template_model(family, len(vocab), model_kwargs, device=device)
    return _flat_variables(model.model)


class _ModelSlot:
    """One immutable serving model: its own eval-mode module with the
    round's variables. Requests snapshot the slot reference once per
    batch, so an engine-level swap can never change state under a running
    batch, and no slot's module is written after it is installed."""

    __slots__ = (
        "round", "source", "module", "vocab", "family", "model_kwargs",
        "n_components", "inference_type", "ctx_size",
    )

    def __init__(self, pub: PublishedModel, module, n_components: int,
                 inference_type: str, ctx_size: int):
        self.round = pub.round
        self.source = pub.source
        self.module = module
        self.vocab = pub.vocab
        self.family = pub.family
        self.model_kwargs = dict(pub.model_kwargs)
        self.n_components = int(n_components)
        self.inference_type = inference_type
        self.ctx_size = int(ctx_size)


class ServingEngine:
    """Bucket-padded, hot-swappable doc→θ inference on one device.

    :meth:`publish` installs a :class:`PublishedModel` (a module of its own
    with the averaged variables loaded, pre-warmed through every bucket)
    behind the quality gate; :meth:`infer` answers one BoW batch against
    whatever slot is installed at that moment. Both are safe to call
    concurrently: ``publish`` serializes on a lock and installs by atomic
    rebind, ``infer`` reads the slot exactly once.

    ``device=None`` is the GPU and raises without CUDA; tests pass
    ``device="cpu"``. ``donate`` is accepted for the JAX signature's sake
    and has no effect: input donation is XLA's.
    """

    def __init__(
        self,
        max_batch: int = 64,
        buckets: tuple[int, ...] | None = None,
        metrics=None,
        logger: logging.Logger | None = None,
        quality_gate: bool = True,
        donate: bool = True,
        warm_on_publish: bool = True,
        device=None,
    ):
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.buckets = tuple(sorted(buckets or default_buckets(max_batch)))
        if self.buckets[-1] != self.max_batch:
            raise ValueError(
                f"largest bucket {self.buckets[-1]} must equal max_batch "
                f"{self.max_batch}"
            )
        self.metrics = metrics
        self.logger = logger or logging.getLogger("ServingEngine")
        self.quality_gate = bool(quality_gate)
        self.donate = bool(donate)
        self.warm_on_publish = bool(warm_on_publish)
        self._slot: _ModelSlot | None = None
        self._publish_lock = threading.Lock()

    # ---- state ------------------------------------------------------------
    @property
    def ready(self) -> bool:
        """Loaded and warm — the ``/ready`` contract."""
        return self._slot is not None

    @property
    def model_round(self) -> int | None:
        slot = self._slot
        return slot.round if slot is not None else None

    @property
    def vocab(self) -> tuple[str, ...] | None:
        """The serving model's consensus vocabulary (token order = BoW
        column order), or None before the first publish."""
        slot = self._slot
        return slot.vocab if slot is not None else None

    def status(self) -> dict[str, Any]:
        """JSON-safe view for ``/status``'s ``serving`` key."""
        slot = self._slot
        reg = self.metrics.registry if self.metrics is not None else None

        def count(name):
            m = reg.get(name) if reg is not None else None
            return int(m.value) if m is not None else 0

        out: dict[str, Any] = {
            "ready": slot is not None,
            "quality_gate": self.quality_gate,
            "max_batch": self.max_batch,
            "buckets": list(self.buckets),
            "swaps": count("serving_swaps"),
            "swaps_refused": count("serving_swaps_refused"),
        }
        if slot is not None:
            out.update(
                model_round=slot.round,
                model_source=slot.source,
                family=slot.family,
                vocab_size=len(slot.vocab),
                n_components=slot.n_components,
            )
        return out

    # ---- hot-swap ---------------------------------------------------------
    def publish(self, pub: PublishedModel) -> bool:
        """Install ``pub`` as the serving model. Returns True when the
        swap happened; False when the candidate was refused (quality
        flag) or is not newer than the installed round. Never tears down
        the installed slot on failure — the last good model keeps
        serving."""
        with self._publish_lock:
            slot = self._slot
            if slot is not None and pub.round <= slot.round:
                return False
            if self.quality_gate and pub.flagged:
                self.logger.warning(
                    "refusing to swap in round %d: the coherence guard "
                    "flagged it (unhealthy streak %s); keeping round %s",
                    pub.round,
                    (pub.quality or {}).get("unhealthy_streak"),
                    slot.round if slot is not None else None,
                )
                if self.metrics is not None:
                    self.metrics.registry.counter(
                        "serving_swaps_refused"
                    ).inc()
                    self.metrics.log(
                        "serve_swap_refused", round=pub.round,
                        reason="coherence_flagged",
                        kept_round=slot.round if slot is not None else None,
                    )
                return False
            new_slot = self._build_slot(pub)
            if self.warm_on_publish:
                # Warm every bucket BEFORE the rebind: the first real
                # request after a swap must not pay for any shape's first
                # launch — in-flight and post-swap traffic both see
                # steady-state latency.
                self._warm(new_slot)
            prev_round = slot.round if slot is not None else None
            self._slot = new_slot
        if self.metrics is not None:
            reg = self.metrics.registry
            if self.device.type == "cuda":
                # Two slots live around the rebind: the swap is serving's
                # device-memory high-water mark.
                idx = self.device.index
                reg.gauge(f"device_bytes_in_use/cuda{idx}").set(
                    torch.cuda.memory_allocated(self.device))
                reg.gauge(f"device_peak_bytes_in_use/cuda{idx}").set(
                    torch.cuda.max_memory_allocated(self.device))
            reg.gauge("serving_model_round").set(pub.round)
            if prev_round is None:
                self.metrics.log(
                    "serve_model_loaded", round=pub.round, source=pub.source,
                )
            else:
                reg.counter("serving_swaps").inc()
                self.metrics.log(
                    "serve_model_swapped", round=pub.round,
                    prev_round=prev_round, source=pub.source,
                )
        self.logger.info(
            "serving round %d (%s)%s", pub.round, pub.source,
            "" if prev_round is None else f" (swapped from {prev_round})",
        )
        return True

    @torch.no_grad()
    def _build_slot(self, pub: PublishedModel) -> _ModelSlot:
        """A new module with one published round's variables. When the
        model identity (family, vocab, kwargs) matches the installed slot,
        start from a copy of ITS module instead of re-initializing — the
        non-averaged leaves are identical by construction (deterministic
        seeded init). The installed module itself is only read."""
        slot = self._slot
        if (
            slot is not None
            and slot.family == pub.family
            and slot.vocab == pub.vocab
            and slot.model_kwargs == dict(pub.model_kwargs)
        ):
            module = copy.deepcopy(slot.module)
            shape = (slot.n_components, slot.inference_type, slot.ctx_size)
        else:
            from gfedntm_tpu_torch.federation.server import build_template_model

            model = build_template_model(
                pub.family, len(pub.vocab), pub.model_kwargs, device=self.device
            )
            module = model.model
            shape = (model.n_components, model.inference_type,
                     model._contextual_size())
        state = module.state_dict()
        keys = _flat_names(state)
        unknown = [k for k in pub.average if k not in keys]
        if unknown:
            raise ValueError(
                f"published round {pub.round} carries keys the template "
                f"does not have (model config drift?): {unknown[:3]}"
            )
        for name, value in pub.average.items():
            path = tuple(name.split("/")[1:])
            state[keys[name]].copy_(interop.from_flax(path, value))
        module.eval()
        module.requires_grad_(False)
        return _ModelSlot(pub, module, *shape)

    def _warm(self, slot: _ModelSlot) -> None:
        vocab_size = len(slot.vocab)
        for bucket in self.buckets:
            x = np.zeros((bucket, vocab_size), np.float32)
            ctx = (
                np.zeros((bucket, slot.ctx_size), np.float32)
                if slot.ctx_size else None
            )
            self._theta(slot, x, ctx)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _theta(self, slot: _ModelSlot, x_bow: np.ndarray,
               x_ctx: np.ndarray | None) -> torch.Tensor:
        """``get_theta(x_bow, x_ctx, noise=0.0)`` of the slot's eval-mode
        module, op for op, without its mode toggles."""
        with torch.inference_mode():
            x = torch.from_numpy(x_bow).to(self.device)
            ctx = torch.from_numpy(x_ctx).to(self.device) if x_ctx is not None else None
            mu, log_sigma = slot.module._encode(x, ctx, None, None, None)
            std = torch.exp(0.5 * log_sigma)
            return torch.softmax(mu + 0.0 * std, dim=1)

    # ---- inference --------------------------------------------------------
    def bucket_for(self, rows: int) -> int:
        """Smallest bucket that holds ``rows`` (callers chunk above
        ``max_batch`` first)."""
        for b in self.buckets:
            if rows <= b:
                return b
        raise ValueError(
            f"batch of {rows} exceeds max_batch {self.max_batch}"
        )

    def infer(
        self, x_bow: np.ndarray, x_ctx: np.ndarray | None = None
    ) -> tuple[np.ndarray, int]:
        """Answer one ``[B, V]`` BoW batch: returns ``(theta [B, K] float32,
        model_round)``. Deterministic (posterior-mean θ, eval-mode BN),
        batch-size invariant under the bucket padding, and pinned to ONE
        slot for its whole duration — a concurrent hot-swap affects only
        later batches."""
        slot = self._slot
        if slot is None:
            raise RuntimeError(
                "serving engine has no model yet (nothing published under "
                "the watched save_dir)"
            )
        x_bow = np.asarray(x_bow, np.float32)
        if x_bow.ndim != 2:
            raise ValueError(f"x_bow must be [B, V], got {x_bow.shape}")
        if x_bow.shape[1] != len(slot.vocab):
            raise ValueError(
                f"x_bow has vocab width {x_bow.shape[1]}, the serving "
                f"model expects {len(slot.vocab)}"
            )
        if slot.ctx_size and x_ctx is None:
            raise ValueError(
                f"the serving model is a CTM ({slot.inference_type} "
                f"encoder): each doc needs a [{slot.ctx_size}]-wide contextual "
                "embedding (x_ctx)"
            )
        if x_ctx is not None:
            x_ctx = np.asarray(x_ctx, np.float32)
        rows = x_bow.shape[0]
        outs = []
        for lo in range(0, rows, self.max_batch):
            chunk = x_bow[lo:lo + self.max_batch]
            ctx_chunk = (
                x_ctx[lo:lo + self.max_batch] if x_ctx is not None else None
            )
            outs.append(self._infer_bucket(slot, chunk, ctx_chunk))
        theta = outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)
        return theta, slot.round

    def _infer_bucket(self, slot, x_bow, x_ctx):
        b = x_bow.shape[0]
        bucket = self.bucket_for(b)
        if bucket != b:
            pad = np.zeros((bucket, x_bow.shape[1]), np.float32)
            pad[:b] = x_bow
            x_bow = pad
            if x_ctx is not None:
                cpad = np.zeros((bucket, x_ctx.shape[1]), np.float32)
                cpad[:b] = x_ctx
                x_ctx = cpad
        if self.metrics is not None:
            reg = self.metrics.registry
            reg.histogram(
                "serve_batch_fill",
                buckets=(0.125, 0.25, 0.5, 0.75, 0.9, 1.0),
            ).observe(b / bucket)
            reg.gauge("serving_batch_fill").set(b / bucket)
            reg.counter("serving_docs").inc(b)
        theta = self._theta(slot, np.ascontiguousarray(x_bow),
                            None if x_ctx is None else np.ascontiguousarray(x_ctx))
        return theta[:b].float().cpu().numpy()
