"""Pluggable server-side aggregation strategies for the federation loop.

A copy of ``gfedntm_tpu/federation/aggregation.py`` (numpy only), kept here
so the port never imports the JAX package; ``tests/test_torch_data_plane.py``
holds every estimator and server optimizer to the original's, bit for bit,
``state_dict`` round trips included.

- :func:`weighted_mean` (:74-83): the reference's sample-weighted mean, its
  expression and operand order the original's, so FedAvg over the same
  snapshots is the same bit for bit;
- the robust mean stages :class:`WeightedMean`, :class:`TrimmedMean`,
  :class:`Median` and :class:`Krum` (with :func:`krum_select` and
  :func:`make_estimator`) and the contribution analytics
  (:func:`contribution_stats`, :func:`contribution_from_gram`), :88-343;
- :class:`ServerAggregator` with its estimator, ``FedAvg`` and the server
  optimizers ``FedAvgM``, ``FedAdam`` and ``FedYogi`` with their
  ``state_dict``/``load_state_dict``, and :func:`make_aggregator`, :345-595.

Every estimator takes either the classic ``[(weight, snapshot), ...]`` list
(the numpy reference, ``_estimate``) or a
:class:`~gfedntm_tpu_torch.federation.device_agg.StackedRound`: the round's
cohort stacked into one ``[N, D]`` float32 tensor on the server's device,
on which the mean stage runs as torch ops (``device_agg.estimate``). The
numpy implementations stay authoritative: the device path matches them
(weighted mean bitwise in float32, the robust estimators to 1e-6).

State is flat ``{"slot::tensor/key": np.ndarray}`` dicts, ``np.savez``-able;
the ``::`` separator cannot collide with the ``/`` inside tensor keys.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

__all__ = [
    "ServerAggregator",
    "FedAvg",
    "FedAvgM",
    "FedAdam",
    "FedYogi",
    "AGGREGATORS",
    "make_aggregator",
    "weighted_mean",
    "RobustEstimator",
    "WeightedMean",
    "TrimmedMean",
    "Median",
    "Krum",
    "krum_select",
    "make_estimator",
    "contribution_stats",
    "contribution_from_gram",
]

def weighted_mean(snapshots) -> dict[str, np.ndarray]:
    """Sample-weighted mean over the shared subset — the exact expression
    (and operand order) of the historical inline path in
    ``server.py``'s round loop, kept verbatim so FedAvg is bit-for-bit."""
    round_weight = float(sum(w for w, _ in snapshots))
    keys = snapshots[0][1].keys()
    return {
        k: sum(w * s[k] for w, s in snapshots) / round_weight
        for k in keys
    }


# ---- robust mean-stage estimators -------------------------------------------

class RobustEstimator:
    """The mean stage of an aggregate step: ``(weight, flat-snapshot)``
    pairs → one flat estimate. Stateless and deterministic.

    ``__call__`` dispatches on the cohort representation: a plain list
    runs the numpy reference implementation (``_estimate``); a
    ``device_agg.StackedRound`` runs the device-resident torch programs,
    which are parity-tested against the numpy oracle."""

    name = "mean"

    def __call__(self, snapshots) -> dict[str, np.ndarray]:
        if not isinstance(snapshots, (list, tuple)):
            from gfedntm_tpu_torch.federation import device_agg

            return device_agg.estimate(self, snapshots)
        return self._estimate(snapshots)

    def _estimate(self, snapshots) -> dict[str, np.ndarray]:
        raise NotImplementedError


class WeightedMean(RobustEstimator):
    """The default (non-robust) estimator: the reference's sample-weighted
    mean, bit-for-bit (see :func:`weighted_mean`)."""

    def _estimate(self, snapshots):
        return weighted_mean(snapshots)


def _stacked(snapshots) -> "tuple[list[str], dict[str, np.ndarray]]":
    """Per-key ``[n_clients, ...]`` float32 stacks of the snapshots.

    The stack buffer is allocated once per key and rows are cast *into*
    it — already-f32 snapshots copy exactly once (the stack itself), and
    non-f32 ones cast in place instead of materializing a per-tensor
    ``asarray`` temporary before ``np.stack`` copies it again."""
    keys = sorted(snapshots[0][1])
    n = len(snapshots)
    stacks: dict[str, np.ndarray] = {}
    for k in keys:
        first = np.asarray(snapshots[0][1][k])
        out = np.empty((n,) + first.shape, np.float32)
        for i, (_w, s) in enumerate(snapshots):
            arr = np.asarray(s[k])
            if arr.shape != first.shape:
                # np.stack used to raise here; the in-place fill would
                # silently BROADCAST a skewed row instead.
                raise ValueError(
                    f"snapshot {i} tensor {k!r} has shape {arr.shape}, "
                    f"expected {first.shape}"
                )
            out[i] = arr
        stacks[k] = out
    return keys, stacks


def _cast_like(est: dict[str, np.ndarray], snapshots) -> dict[str, np.ndarray]:
    ref = snapshots[0][1]
    return {
        k: np.asarray(v, dtype=np.asarray(ref[k]).dtype)
        for k, v in est.items()
    }


class TrimmedMean(RobustEstimator):
    """Coordinate-wise trimmed mean (Yin et al., 2018): per coordinate,
    drop the ``floor(frac * n)`` largest AND smallest client values, then
    average the rest unweighted. Tolerates up to ``floor(frac * n)``
    byzantine clients per coordinate; weights are deliberately ignored —
    a byzantine client must not be able to buy influence by inflating its
    claimed sample count."""

    def __init__(self, frac: float = 0.2):
        if not 0.0 <= frac < 0.5:
            raise ValueError(
                f"trimmed_mean fraction must be in [0, 0.5), got {frac}"
            )
        self.frac = float(frac)
        self.name = f"trimmed_mean:{self.frac:g}"

    def _estimate(self, snapshots):
        n = len(snapshots)
        # frac < 0.5 guarantees 2t < n: at least one value survives the
        # trim for every cohort size.
        t = int(self.frac * n)
        keys, stacks = _stacked(snapshots)
        est = {}
        for k in keys:
            if t == 0:
                est[k] = stacks[k].mean(axis=0)
                continue
            # Partial selection instead of a full sort: pinning ranks
            # t-1 and n-t puts the t smallest values below index t and
            # the t largest at/after index n-t, which is all the trim
            # needs — O(N) per coordinate instead of O(N log N).
            s = np.partition(stacks[k], (t - 1, n - t), axis=0)
            est[k] = s[t:n - t].mean(axis=0)
        return _cast_like(est, snapshots)


class Median(RobustEstimator):
    """Coordinate-wise median (the frac→0.5 limit of the trimmed mean):
    the strongest per-coordinate breakdown point, at the cost of ignoring
    half the cohort's information per coordinate."""

    name = "median"

    def _estimate(self, snapshots):
        keys, stacks = _stacked(snapshots)
        return _cast_like(
            {k: np.median(stacks[k], axis=0) for k in keys}, snapshots
        )


def krum_select(d2: np.ndarray, n: int, f: int) -> np.ndarray:
    """Multi-Krum selection from a pairwise squared-distance matrix: score
    each client by its summed distance to its ``n - f - 2`` nearest peers,
    keep the ``n - f`` best (stable order). Shared verbatim by the numpy
    and device backends so neighbor selection cannot drift between them.
    Non-finite distances (NaN updates, overflow against one) become +inf:
    never selected, never poisoning an honest score."""
    d2 = np.where(np.isfinite(d2), np.maximum(d2, 0.0), np.inf)
    np.fill_diagonal(d2, np.inf)
    k_near = max(1, n - f - 2)
    neighbor_d2 = np.sort(d2, axis=1)[:, :k_near]
    scores = neighbor_d2.sum(axis=1)
    m = max(1, n - f)
    return np.argsort(scores, kind="stable")[:m]


class Krum(RobustEstimator):
    """Multi-Krum (Blanchard et al., 2017) over flattened updates: each
    client is scored by the summed squared distance to its ``n - f - 2``
    nearest peers; the ``n - f`` best-scored clients are kept and averaged
    with their sample weights (they are all honest-cluster members by
    selection, so weighting is safe again). Unlike the coordinate-wise
    estimators this drops whole *clients*, so a single totally-bogus
    update (NaN tensors included — non-finite rows score ``inf`` and are
    never selected) cannot leak into any coordinate."""

    def __init__(self, f: int = 1):
        if f < 0:
            raise ValueError(f"krum byzantine count must be >= 0, got {f}")
        self.f = int(f)
        self.name = f"krum:{self.f}"

    def _estimate(self, snapshots):
        n = len(snapshots)
        if n - self.f < 2:
            # Too small a cohort to score against itself — fall back to the
            # median rather than silently trusting everyone.
            return Median()(snapshots)
        keys = sorted(snapshots[0][1])
        flat = np.stack([
            np.concatenate([
                np.asarray(s[k], np.float32).ravel() for k in keys
            ])
            for _w, s in snapshots
        ])
        # Pairwise squared distances via the gram identity
        # ‖a−b‖² = ‖a‖² + ‖b‖² − 2a·b — O(n² + nD) memory, where the
        # broadcasted difference cube would be O(n²D) (gigabytes at fleet
        # scale). Selection semantics (incl. the non-finite → +inf guard)
        # live in :func:`krum_select`, shared with the device backend.
        sq = np.einsum("ij,ij->i", flat, flat)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (flat @ flat.T)
        chosen = krum_select(d2, n, self.f)
        return weighted_mean([snapshots[i] for i in chosen])


_ESTIMATORS: dict[str, type] = {
    "mean": WeightedMean, "trimmed_mean": TrimmedMean, "median": Median,
    "krum": Krum,
}


def make_estimator(
    spec: "str | RobustEstimator | None",
) -> RobustEstimator:
    """Parse a robust-estimator spec: ``mean`` (default), ``median``,
    ``trimmed_mean[:<frac>]``, ``krum[:<f>]``."""
    if isinstance(spec, RobustEstimator):
        return spec
    raw = (spec or "mean").strip().lower()
    name, _, arg = raw.partition(":")
    cls = _ESTIMATORS.get(name)
    if cls is None:
        raise ValueError(
            f"unknown robust estimator {raw!r} (want one of "
            f"{sorted(_ESTIMATORS)}, with trimmed_mean:<frac> / krum:<f>)"
        )
    if not arg:
        return cls()
    if cls is TrimmedMean:
        return cls(float(arg))
    if cls is Krum:
        return cls(int(arg))
    raise ValueError(f"estimator {name!r} takes no {arg!r} argument")


# ---- per-client contribution analytics (model-quality plane) ----------------

def contribution_from_gram(
    dots: np.ndarray,
) -> "tuple[np.ndarray, np.ndarray, float, float]":
    """Finish contribution analytics from an ``[N+1, N+1]`` gram matrix of
    the update rows ``(u_1, ..., u_N, u_agg)`` where ``u_i = snapshot_i -
    current_global`` and ``u_agg = aggregate - current_global``.

    Returns ``(cos_to_agg [N], update_norms [N], pair_mean, pair_min)``:
    each admitted client's cosine alignment with the accepted aggregate
    update, its raw update norm, and the mean/min off-diagonal pairwise
    client cosine — the cohort-dispersion (non-IID) signal. Shared by the
    numpy oracle and the device backend so the finishing arithmetic
    cannot drift between them (only the gram's producer differs)."""
    dots = np.asarray(dots, np.float64)
    norms = np.sqrt(np.clip(np.diagonal(dots), 0.0, None))
    denom = np.maximum(np.outer(norms, norms), 1e-30)
    cos = dots / denom
    n = dots.shape[0] - 1
    cos_to_agg = cos[:n, n].copy()
    if n >= 2:
        iu = np.triu_indices(n, 1)
        off = cos[:n, :n][iu]
        pair_mean, pair_min = float(off.mean()), float(off.min())
    else:
        pair_mean = pair_min = float("nan")
    return cos_to_agg, norms[:n].copy(), pair_mean, pair_min


def contribution_stats(
    snapshots: "list[dict[str, np.ndarray]]",
    current_global: Mapping[str, np.ndarray],
    average: Mapping[str, np.ndarray],
) -> "tuple[np.ndarray, np.ndarray, float, float]":
    """Numpy reference for per-client contribution analytics (see
    :func:`contribution_from_gram`): flatten each admitted snapshot over
    the sorted shared keys (the same layout the estimators and the device
    plane use), subtract the current global, and take the gram of the
    update rows plus the aggregate update in float64. The device backend
    (``device_agg.DeviceAggEngine.contribution_stats``) reuses the
    already-stacked round plane and must match this to 1e-6 cosine."""
    keys = sorted(snapshots[0])

    def flat(d: Mapping[str, np.ndarray]) -> np.ndarray:
        return np.concatenate(
            [np.asarray(d[k], np.float64).ravel() for k in keys]
        )

    g = flat(current_global)
    rows = np.stack([flat(s) for s in snapshots] + [flat(average)]) - g
    return contribution_from_gram(rows @ rows.T)


# ---- aggregators -------------------------------------------------------------

class ServerAggregator:
    """One round's aggregate step: ``snapshots`` (per-client ``(weight,
    flat-snapshot)`` pairs, already decoded and key-validated) plus the
    server's ``current_global`` (the last broadcast average, or the template
    init before round 0) map to the new global parameters.

    ``estimator`` swaps the mean stage for a byzantine-robust location
    estimate (see :func:`make_estimator`); the default
    :class:`WeightedMean` keeps every aggregator numerically identical to
    its pre-robustness behaviour. A non-default estimator is reflected in
    :attr:`name` (e.g. ``"fedadam+median"``) so checkpoint compatibility
    checks see the full aggregation configuration.

    Stateless aggregators return ``None`` from :meth:`state_dict`; stateful
    ones return a flat npz-able array dict and accept it back via
    :meth:`load_state_dict` on ``--resume``.

    ``noiser`` (default None — bitwise no-op) is the server-side FedLD
    DP mechanism (:class:`gfedntm_tpu_torch.privacy.mechanisms.ServerNoiser`),
    applied to the mean stage's output *after* the robust estimate: the
    estimator first discards the byzantine tail, then calibrated
    Gaussian noise lands on the clean estimate — composing robustness
    and privacy without either masking the other. The hook sits in
    :meth:`_mean` so every aggregator (plain assignment and the slotted
    server optimizers alike) injects noise into the same place the
    sensitivity analysis bounds: the admitted cohort's location
    estimate. The noiser deliberately does NOT join :attr:`name` — the
    estimator composition is checkpoint identity, the noise mechanism
    is run configuration carried by the privacy ledger.
    """

    name = "base"

    def __init__(self, estimator: "str | RobustEstimator | None" = None):
        self.estimator = make_estimator(estimator)
        #: Optional server-side DP noise mechanism (set by the server
        #: when ``--dp server``; None leaves every path bitwise intact).
        self.noiser = None
        if self.estimator.name != "mean":
            # Instance attribute shadows the class name: the composition is
            # part of the aggregator's identity (checkpoints, /status).
            self.name = f"{type(self).name}+{self.estimator.name}"

    def _mean(self, snapshots) -> dict[str, np.ndarray]:
        est = self.estimator(snapshots)
        if self.noiser is not None:
            est = self.noiser.apply(est, len(snapshots))
        return est

    def aggregate(
        self,
        snapshots,
        current_global: Mapping[str, np.ndarray],
    ) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def state_dict(self) -> "dict[str, np.ndarray] | None":
        return None

    def load_state_dict(self, arrays: Mapping[str, np.ndarray]) -> None:
        if arrays:
            raise ValueError(
                f"{self.name} aggregator is stateless but was handed "
                f"{len(arrays)} state arrays"
            )


class FedAvg(ServerAggregator):
    """The reference semantics: assign the sample-weighted mean (or, with a
    robust estimator, assign the robust estimate)."""

    name = "fedavg"

    def aggregate(self, snapshots, current_global=None):
        return self._mean(snapshots)


class _SlottedAggregator(ServerAggregator):
    """Common machinery for server-optimizer aggregators: per-tensor float32
    slot state, pseudo-gradient computation, flat state (de)serialization."""

    #: slot names this aggregator carries (e.g. ("m",) or ("m", "v")).
    slots: tuple[str, ...] = ()

    def __init__(self, server_lr: float = 1.0, estimator=None):
        super().__init__(estimator)
        self.server_lr = float(server_lr)
        self._state: dict[str, dict[str, np.ndarray]] = {
            s: {} for s in self.slots
        }

    def _slot(self, slot: str, key: str, like: np.ndarray) -> np.ndarray:
        arr = self._state[slot].get(key)
        if arr is None or arr.shape != like.shape:
            arr = np.zeros(like.shape, dtype=np.float32)
            self._state[slot][key] = arr
        return arr

    def aggregate(self, snapshots, current_global):
        mean = self._mean(snapshots)
        out: dict[str, np.ndarray] = {}
        for key, avg in mean.items():
            cur = np.asarray(current_global[key])
            if avg.dtype.kind != "f":
                # Non-float shared state (none today, but the mask is
                # config-driven): fall through to plain averaging.
                out[key] = avg
                continue
            delta = (np.asarray(avg, np.float32)
                     - np.asarray(cur, np.float32))
            update = self._update(key, delta)
            out[key] = (
                np.asarray(cur, np.float32) + self.server_lr * update
            ).astype(avg.dtype)
        return out

    def _update(self, key: str, delta: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def state_dict(self):
        # Copies, not views: the slots are mutated in place every round,
        # and a state_dict that aliases them would silently change after
        # the fact (and couple a restored twin to the donor).
        return {
            f"{slot}::{key}": np.array(arr, copy=True)
            for slot, tensors in self._state.items()
            for key, arr in tensors.items()
        }

    def load_state_dict(self, arrays):
        state: dict[str, dict[str, np.ndarray]] = {s: {} for s in self.slots}
        for flat_key, arr in arrays.items():
            slot, _, key = flat_key.partition("::")
            if not key or slot not in state:
                raise ValueError(
                    f"bad {self.name} state key {flat_key!r} (want "
                    f"'<slot>::<tensor>' with slot in {self.slots})"
                )
            state[slot][key] = np.array(arr, dtype=np.float32, copy=True)
        self._state = state


class FedAvgM(_SlottedAggregator):
    """Server momentum (Hsu et al.): ``m = beta * m + delta;
    x += lr * m``."""

    name = "fedavgm"
    slots = ("m",)

    def __init__(self, server_lr: float = 1.0, beta: float = 0.9,
                 estimator=None):
        super().__init__(server_lr, estimator=estimator)
        self.beta = float(beta)

    def _update(self, key, delta):
        m = self._slot("m", key, delta)
        m *= self.beta
        m += delta
        return m


class FedAdam(_SlottedAggregator):
    """Adaptive server optimizer (Reddi et al., Alg. 2): first/second
    moments of the pseudo-gradient, no bias correction, ``tau`` floors the
    denominator. The per-minibatch exchange makes deltas one-optimizer-step
    small, so the default ``server_lr`` is conservative."""

    name = "fedadam"
    slots = ("m", "v")

    def __init__(self, server_lr: float = 0.02, beta1: float = 0.9,
                 beta2: float = 0.99, tau: float = 1e-3, estimator=None):
        super().__init__(server_lr, estimator=estimator)
        self.beta1, self.beta2, self.tau = (
            float(beta1), float(beta2), float(tau)
        )

    def _second_moment(self, v: np.ndarray, delta_sq: np.ndarray) -> None:
        v *= self.beta2
        v += (1.0 - self.beta2) * delta_sq

    def _update(self, key, delta):
        m = self._slot("m", key, delta)
        v = self._slot("v", key, delta)
        m *= self.beta1
        m += (1.0 - self.beta1) * delta
        self._second_moment(v, np.square(delta))
        return m / (np.sqrt(v) + self.tau)


class FedYogi(FedAdam):
    """FedAdam with Yogi's sign-controlled second moment (Reddi et al.):
    ``v -= (1 - beta2) * delta^2 * sign(v - delta^2)`` — additive, so ``v``
    cannot grow multiplicatively fast on heavy-tailed pseudo-gradients."""

    name = "fedyogi"

    def _second_moment(self, v, delta_sq):
        v -= (1.0 - self.beta2) * delta_sq * np.sign(v - delta_sq)


AGGREGATORS: dict[str, type] = {
    a.name: a for a in (FedAvg, FedAvgM, FedAdam, FedYogi)
}


def make_aggregator(
    spec: "str | ServerAggregator | None",
    robust: "str | RobustEstimator | None" = None,
    **kwargs: Any,
) -> ServerAggregator:
    """Resolve a CLI name (or pass through an instance) to an aggregator.

    ``robust`` is a robust-estimator spec (``--robust_aggregator``:
    ``median``, ``trimmed_mean:<frac>``, ``krum:<f>``) substituted for the
    aggregator's weighted-mean stage. A robust spec passed AS the
    aggregator name (e.g. ``spec="median"``) is accepted too and means
    plain assignment of the robust estimate (FedAvg semantics)."""
    if isinstance(spec, ServerAggregator):
        if kwargs or robust is not None:
            raise ValueError(
                "kwargs/robust are for by-name construction only"
            )
        return spec
    name = (spec or "fedavg").strip().lower()
    cls = AGGREGATORS.get(name)
    if cls is None:
        # Not a server-optimizer name: accept a bare robust spec as
        # "fedavg with that estimator".
        try:
            est = make_estimator(name)
        except ValueError:
            raise ValueError(
                f"unknown aggregator {name!r} (want one of "
                f"{sorted(AGGREGATORS)}, or a robust estimator spec "
                f"median / trimmed_mean:<frac> / krum:<f>)"
            ) from None
        if robust is not None:
            raise ValueError(
                f"aggregator {name!r} is itself a robust estimator; "
                "drop the extra robust spec"
            )
        if kwargs:
            raise ValueError(
                f"aggregator {name!r} assigns the robust estimate "
                f"directly and takes no server-optimizer kwargs "
                f"({sorted(kwargs)}); use fedavgm/fedadam/fedyogi with "
                "robust= for that"
            )
        return FedAvg(estimator=est)
    return cls(estimator=make_estimator(robust), **kwargs)
