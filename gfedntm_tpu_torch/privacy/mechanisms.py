"""DP noise mechanisms: server-side FedLD noise and client-side DP-SGD.

A copy of ``gfedntm_tpu/privacy/mechanisms.py`` (``DPSpec``, ``parse_dp``,
``host_noise_vector``, ``ServerNoiser``, ``ClientSanitizer``), kept here
so the port never imports the JAX package. One import differs:
``ServerNoiser._noise_vec`` reaches the port's
:class:`~gfedntm_tpu_torch.federation.device_agg.FlatPlane` and
:meth:`~gfedntm_tpu_torch.federation.device_agg.DeviceAggEngine.noise_vector`.

Both mechanisms draw their noise over the round's float32 tensors in
sorted key order from an explicitly seeded generator, never ambient RNG
state. The numpy oracle (:func:`host_noise_vector`,
``np.random.default_rng((seed, index))``) is the reference. The device
path (a Philox ``torch.Generator`` on the server's device) is
deliberately not bitwise equal to it: each path is exactly reproducible
per (seed, application index), both are zero-mean Gaussian at the same
std, and the privacy accounting depends only on the std.

Sensitivity: in server mode the update gate's clip is tightened to
``dp_clip``, so the weighted mean of n admitted updates has sensitivity
``clip / n`` and the noise std is ``sigma * clip / max(1, n)``. In client
mode each client clips its own outgoing delta and adds ``sigma * clip``
noise before the update leaves it (local DP).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np

__all__ = [
    "DPSpec",
    "parse_dp",
    "host_noise_vector",
    "ServerNoiser",
    "ClientSanitizer",
]

DP_MODES = ("off", "server", "client")


@dataclass(frozen=True)
class DPSpec:
    """Parsed ``--dp`` configuration (see :func:`parse_dp`)."""

    mode: str  # "off" | "server" | "client"
    clip: float = 1.0  # L2 sensitivity bound (the DP clip)
    sigma: float = 0.0  # noise multiplier (std = sigma x sensitivity)
    delta: float = 1e-5  # the delta the (eps, delta) ledger reports at
    budget: float = 0.0  # declared eps budget (0 = track only)
    seed: int = 0  # mechanism seed (never ambient RNG state)

    @property
    def enabled(self) -> bool:
        return self.mode != "off"


def parse_dp(
    mode: "str | DPSpec | None",
    *,
    clip: float = 1.0,
    sigma: float = 0.0,
    delta: float = 1e-5,
    budget: float = 0.0,
    seed: int = 0,
) -> DPSpec:
    """Parse the ``--dp`` knobs into a validated spec. ``off`` ignores
    every other knob (and the caller constructs no mechanism objects at
    all — the bitwise default-off contract)."""
    if isinstance(mode, DPSpec):
        return mode
    raw = (mode or "off").strip().lower()
    if raw not in DP_MODES:
        raise ValueError(
            f"unknown dp mode {raw!r} (want one of {DP_MODES})"
        )
    if raw == "off":
        return DPSpec("off")
    if clip <= 0.0:
        raise ValueError(f"--dp_clip must be > 0, got {clip}")
    if sigma <= 0.0:
        raise ValueError(
            f"--dp {raw} needs a positive noise multiplier --dp_sigma, "
            f"got {sigma}"
        )
    if not 0.0 < delta < 1.0:
        raise ValueError(f"--dp_delta must be in (0, 1), got {delta}")
    if budget < 0.0:
        raise ValueError(f"--dp_budget must be >= 0, got {budget}")
    return DPSpec(
        raw, clip=float(clip), sigma=float(sigma), delta=float(delta),
        budget=float(budget), seed=int(seed),
    )


def host_noise_vector(
    dim: int, std: float, seed: int, index: int,
    extra: "tuple[int, ...]" = (),
) -> np.ndarray:
    """The numpy noise oracle: ``dim`` float32 standard-normal draws
    scaled by ``std``, from a generator seeded by the tuple
    ``(seed, *extra, index)`` — deterministic per application, shared by
    the server host path and the client sanitizer (with the client id in
    ``extra`` so clients never draw correlated noise)."""
    rng = np.random.default_rng((int(seed),) + tuple(
        int(x) for x in extra
    ) + (int(index),))
    return (
        rng.standard_normal(int(dim)).astype(np.float32)
        * np.float32(std)
    )


def _f32_layout(
    average: Mapping[str, Any],
) -> "list[tuple[str, int, int]]":
    """(key, offset, size) slices of the sorted-f32-key noise vector."""
    out: list[tuple[str, int, int]] = []
    off = 0
    for k in sorted(average):
        arr = np.asarray(average[k])
        if arr.dtype == np.float32:
            out.append((k, off, int(arr.size)))
            off += int(arr.size)
    return out


class ServerNoiser:
    """FedLD posterior-sampling noise on the server aggregate.

    Applied by :meth:`aggregation.ServerAggregator._mean` **after** the
    (possibly robust) mean stage — robust estimators first discard the
    byzantine tail, then calibrated Gaussian noise is added to the clean
    estimate, so noise can never mask a poisoned update from the robust
    screen (README "Differential privacy & posterior sampling").

    The noiser keeps its own application counter: draw ``i`` is a pure
    function of ``(spec.seed, i)``, so a crash-autorecovered server that
    restores the counter from the accountant's step count resumes the
    exact noise stream. ``device_engine`` switches generation to the
    engine's device (:meth:`DeviceAggEngine.noise_vector`, a seeded
    Philox generator); the numpy oracle is the default and the
    reference.
    """

    name = "fedld"

    def __init__(
        self,
        spec: DPSpec,
        *,
        device_engine: Any = None,
        metrics: Any = None,
    ):
        if spec.mode != "server":
            raise ValueError(
                f"ServerNoiser needs a server-mode spec, got {spec.mode!r}"
            )
        self.spec = spec
        self.device_engine = device_engine
        self.metrics = metrics
        #: Applications so far — restored to the accountant's step count
        #: on crash recovery so the noise stream continues, not restarts.
        self.applications = 0
        self._plane_cache: "tuple[tuple, Any] | None" = None

    def noise_std(self, n_contributors: int) -> float:
        """Noise std for an n-contributor aggregate: the mean of n
        clip-bounded updates has L2 sensitivity ``clip / n``."""
        return self.spec.sigma * self.spec.clip / max(1, int(n_contributors))

    def _noise_vec(self, average: Mapping[str, Any], dim: int,
                   std: float, index: int) -> np.ndarray:
        if self.device_engine is None:
            return host_noise_vector(dim, std, self.spec.seed, index)
        from gfedntm_tpu_torch.federation.device_agg import FlatPlane

        keys = tuple(sorted(
            k for k in average
            if np.asarray(average[k]).dtype == np.float32
        ))
        cached = self._plane_cache
        if cached is None or cached[0] != keys:
            plane = FlatPlane({k: average[k] for k in keys})
            self._plane_cache = (keys, plane)
        else:
            plane = cached[1]
        return self.device_engine.noise_vector(
            plane, std=std, seed=self.spec.seed, index=index,
        )

    def apply(
        self, average: "dict[str, np.ndarray]", n_contributors: int,
    ) -> "dict[str, np.ndarray]":
        """Add calibrated Gaussian noise to the aggregate's float32
        tensors (non-f32 tensors — int batch counters — carry no client
        signal the mechanism models and pass through untouched)."""
        layout = _f32_layout(average)
        index = self.applications
        self.applications += 1
        std = self.noise_std(n_contributors)
        dim = sum(size for _k, _off, size in layout)
        vec = self._noise_vec(average, dim, std, index)
        out = dict(average)
        for key, off, size in layout:
            arr = np.asarray(average[key])
            out[key] = arr + vec[off:off + size].reshape(arr.shape)
        if self.metrics is not None:
            self.metrics.log(
                "dp_noise_applied", mode="server", index=index,
                std=float(std), n=int(n_contributors), dim=int(dim),
                backend=(
                    "device" if self.device_engine is not None else "host"
                ),
            )
        return out


class ClientSanitizer:
    """Client-side DP-SGD on the outgoing update: clip the round delta
    to the L2 ball ``clip`` (the gate-clip semantics, applied at the
    source), then add ``sigma * clip`` Gaussian noise — the update is
    differentially private before it leaves the client, so the server,
    every relay tier, and any wire observer see only the sanitized
    version (local DP)."""

    def __init__(self, spec: DPSpec, *, client_id: int = 0,
                 metrics: Any = None):
        if spec.mode != "client":
            raise ValueError(
                f"ClientSanitizer needs a client-mode spec, "
                f"got {spec.mode!r}"
            )
        self.spec = spec
        self.client_id = int(client_id)
        self.metrics = metrics
        self.applications = 0

    def apply(
        self,
        params: "dict[str, np.ndarray]",
        reference: "Mapping[str, np.ndarray]",
        round_index: int,
    ) -> "dict[str, np.ndarray]":
        """Sanitize one outgoing parameter bundle against ``reference``
        (the last applied aggregate, or the initial template before any
        broadcast): clip the float delta, noise the float32 tensors,
        return ``reference + sanitized delta`` in the bundle's dtypes."""
        spec = self.spec
        # Global L2 of the float delta in f64 — the same accumulation
        # sanitize.update_norm uses, so the clip ball is the ball the
        # server's admission gate measures.
        sq = 0.0
        fkeys = []
        for k in sorted(params):
            arr = np.asarray(params[k])
            if arr.dtype.kind != "f":
                continue
            fkeys.append(k)
            d = (np.asarray(arr, np.float64)
                 - np.asarray(reference[k], np.float64))
            sq += float(np.sum(d * d))
        norm = float(np.sqrt(sq))
        factor = min(1.0, spec.clip / norm) if norm > 0.0 else 1.0
        index = self.applications
        self.applications += 1
        std = spec.sigma * spec.clip
        layout = _f32_layout({k: params[k] for k in fkeys})
        dim = sum(size for _k, _off, size in layout)
        # The draw is keyed by the APPLICATION counter, not the round: an
        # async/push client can uplink several snapshots at the same base
        # round, and reusing a noise vector across distinct uplinks would
        # correlate them (breaking the independent-Gaussian assumption the
        # accountant composes over).
        vec = host_noise_vector(
            dim, std, spec.seed, index, extra=(self.client_id,),
        )
        out = dict(params)
        noise_by_key = {k: (off, size) for k, off, size in layout}
        for k in fkeys:
            arr = np.asarray(params[k])
            ref = np.asarray(reference[k], np.float64)
            delta = np.asarray(arr, np.float64) - ref
            if factor < 1.0:
                delta = factor * delta
            sanitized = ref + delta
            if k in noise_by_key:
                off, size = noise_by_key[k]
                sanitized = sanitized + np.asarray(
                    vec[off:off + size].reshape(arr.shape), np.float64
                )
            out[k] = np.asarray(sanitized, dtype=arr.dtype)
        if self.metrics is not None:
            self.metrics.log(
                "dp_noise_applied", mode="client", index=index,
                std=float(std), n=1, dim=int(dim),
                round=int(round_index), norm=norm,
                clipped=bool(factor < 1.0),
            )
        return out
