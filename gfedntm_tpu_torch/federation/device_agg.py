"""Device-resident aggregation data plane.

Counterpart of ``gfedntm_tpu/federation/device_agg.py``. The round's
admitted client snapshots are flattened once each into one ``[N, D]``
float32 tensor on the server's device (``None`` is the GPU), and the
admission gate's statistics, its norm clip and the robust mean stage run
there as torch ops instead of per-tensor host numpy loops:

- the :class:`~gfedntm_tpu_torch.federation.sanitize.UpdateGate`'s
  finiteness count and per-client update norms (:meth:`DeviceAggEngine.gate_stats`);
- the norm clip, per-row factors (:meth:`DeviceAggEngine.clip`);
- the weighted mean, trimmed mean, coordinate median and Krum's pairwise
  distances (:func:`estimate`), and the contribution analytics' gram.

The JAX engine shards the plane over a device mesh with ``shard_map``;
here it lives on one device and only [N]-sized results, [N, N] grams and
the [D] estimate return to the host. The JAX plane is plain XLA with no
Pallas kernel, so these are plain torch ops on the card.

**Parity contract** (``tests/test_torch_data_plane.py`` on the CPU,
``chip_smoke.py`` phase 10(a) on the card; the JAX module's :32-45): the
numpy implementations in :mod:`gfedntm_tpu_torch.federated.aggregation` and
:mod:`gfedntm_tpu_torch.federation.sanitize` are the oracle.

- The weighted mean is bitwise numpy's float32 chain
  ``sum(w * s[k] for ...) / round_weight``: one ``mul`` and one ``add``
  kernel per row, starting from zeros as Python's ``sum`` starts from 0,
  each weight ``np.float32(w)`` as a 0-d tensor on the device, and one
  division by the round weight, rounded once to float32 on the host and
  also put on the device (a fused multiply-add, or PyTorch's CUDA division
  by a host scalar, which multiplies by its reciprocal, each round once
  where numpy rounds twice).
- The coordinate median sorts along the client axis and averages the two
  middle values of an even cohort in float32, as ``np.median`` does
  (``torch.median`` returns the lower one; ``torch.quantile`` refuses more
  than 2^24 elements); a coordinate with a NaN is NaN, as in numpy. The
  trimmed mean sorts the same way (NaN sorts last in both).
- Update norms subtract and accumulate in float64, as
  ``sanitize.update_norm`` does (a poisoned float32 row overflows a float32
  square); a clip computes its rows in float64 and rounds once, as the
  numpy clip does, and a row whose factor is 1.0 passes through verbatim.
- Krum's distances and the contribution analytics come from grams taken in
  float64, which TF32 never touches whatever the global matmul setting:
  the gram identity cancels for nearby clients, and a float32 product over
  D=10,052,752 values misses the exact gram by more than the 1e-6 the
  parity holds (``chip_smoke.py`` phase 10(a) prints numpy's own error).
- Every admission decision is the numpy gate's; non-float32 leaves keep
  the numpy expressions (:func:`_non_f32_weighted_mean`).

DP noise (:meth:`DeviceAggEngine.noise_vector`, the server-mode
``ServerNoiser``'s device path) is drawn on the engine's device from an
explicit Philox ``torch.Generator`` seeded per ``(seed, index)``, never
from ambient RNG state. As in the JAX engine (a jitted ``jax.random``
program there, no Pallas kernel) the draw is exactly reproducible per
``(seed, index)``, zero-mean Gaussian at the requested std, and
deliberately not bitwise equal to the numpy oracle
(:func:`~gfedntm_tpu_torch.privacy.mechanisms.host_noise_vector`).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from gfedntm_tpu_torch.device import resolve_device

__all__ = [
    "noise_seed",
    "FlatPlane",
    "StackedRound",
    "DeviceAggEngine",
    "stack_round",
    "estimate",
]


class FlatPlane:
    """Key layout of the flattened float32 parameter plane (a copy of the
    JAX class).

    Keys are sorted (the exact order ``aggregation._stacked`` and Krum's
    flatten use), each tensor raveled C-order into one contiguous
    ``[D]`` float32 vector. Non-float32 tensors are cast into the plane
    (for norms/distances — mirroring ``sanitize.update_norm`` and the
    numpy estimators' f32 stacks) and remembered in ``non_f32_keys`` so
    estimate reconstruction can delegate them back to numpy semantics.
    """

    def __init__(self, template: Mapping[str, Any]):
        self.keys: list[str] = sorted(template)
        self.shapes: dict[str, tuple] = {}
        self.dtypes: dict[str, np.dtype] = {}
        self.offsets: dict[str, tuple[int, int]] = {}
        off = 0
        for k in self.keys:
            arr = np.asarray(template[k])
            self.shapes[k] = tuple(arr.shape)
            self.dtypes[k] = arr.dtype
            self.offsets[k] = (off, int(arr.size))
            off += int(arr.size)
        self.dim = off
        self.non_f32_keys: list[str] = [
            k for k in self.keys if self.dtypes[k] != np.float32
        ]

    def flatten(self, snap: Mapping[str, Any], out: np.ndarray | None = None
                ) -> np.ndarray:
        """One pass: fill a ``[D]`` f32 vector (casting in place — no
        per-tensor cast temporaries)."""
        if out is None:
            out = np.empty(self.dim, np.float32)
        for k in self.keys:
            off, size = self.offsets[k]
            out[off:off + size] = np.asarray(snap[k]).reshape(-1)
        return out

    def unflatten(self, vec: np.ndarray, cast: bool = True
                  ) -> dict[str, np.ndarray]:
        """``[>=D]`` f32 vector back to the keyed dict; ``cast`` restores
        each tensor's template dtype (the numpy estimators' ``_cast_like``
        semantics — float32 keys stay zero-copy views)."""
        est: dict[str, np.ndarray] = {}
        for k in self.keys:
            off, size = self.offsets[k]
            arr = vec[off:off + size].reshape(self.shapes[k])
            if cast and arr.dtype != self.dtypes[k]:
                arr = arr.astype(self.dtypes[k])
            est[k] = arr
        return est


class StackedRound:
    """One round's admitted cohort, stacked on the engine's device.

    ``mat`` is the ``[N, D]`` float32 tensor (rows in admission order);
    ``weights`` keeps the Python-float sample weights (their sum, rounded
    once to float32, is the FedAvg denominator, as numpy computes it);
    ``snapshots`` keeps the decoded host dicts, row-aligned, for the
    non-f32 remainder. ``gvec`` is the ``[D]`` current-global vector the
    admission gate staged, which the contribution analytics reuse.
    """

    def __init__(self, engine: "DeviceAggEngine", plane: FlatPlane,
                 weights: list[float], mat: torch.Tensor, snapshots: list,
                 gvec: torch.Tensor | None = None):
        self.engine = engine
        self.plane = plane
        self.weights = list(weights)
        self.mat = mat
        self.snapshots = list(snapshots)
        self.gvec = gvec

    @property
    def pairs(self) -> list:
        """``[(weight, snapshot)]`` view — the numpy estimators' input."""
        return list(zip(self.weights, self.snapshots))

    def __len__(self) -> int:
        return int(self.mat.shape[0])

    def subset(self, idx) -> "StackedRound":
        """Row subset, gathered on the device."""
        idx = [int(i) for i in idx]
        return StackedRound(
            self.engine, self.plane,
            [self.weights[i] for i in idx],
            self.mat[torch.as_tensor(idx, device=self.mat.device)],
            [self.snapshots[i] for i in idx],
            gvec=self.gvec,
        )


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def noise_seed(seed: int, index: int) -> int:
    """The 64-bit Philox seed of DP noise application ``index`` under
    mechanism ``seed``: the first word of
    ``np.random.SeedSequence((seed, index))``'s state, so every pair maps
    to a well-mixed, distinct seed."""
    state = np.random.SeedSequence((int(seed), int(index))).generate_state(1, np.uint64)
    return int(state[0])


class DeviceAggEngine:
    """The aggregation data plane's programs on one device (``None`` is the
    GPU, which must be present; the tests pass ``"cpu"``). Stateless
    between rounds; one per server."""

    def __init__(self, device: str | torch.device | None = None):
        self.device = resolve_device(device)

    # ---- staging -------------------------------------------------------
    def stack(self, plane: FlatPlane, snaps: list[Mapping[str, Any]]) -> torch.Tensor:
        """Stack N snapshots into the ``[N, D]`` device plane: the round's
        one host flatten and one transfer."""
        mat = np.empty((len(snaps), plane.dim), np.float32)
        for i, snap in enumerate(snaps):
            plane.flatten(snap, out=mat[i])
        return torch.from_numpy(mat).to(self.device)

    def put_vector(self, plane: FlatPlane, snap: Mapping[str, Any]) -> torch.Tensor:
        """Flatten and stage one reference vector (the current global)."""
        return torch.from_numpy(plane.flatten(snap)).to(self.device)

    # ---- gate data plane -----------------------------------------------
    def gate_stats(self, mat: torch.Tensor, gvec: torch.Tensor
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Finiteness and update norms. Returns ``(nonfinite_counts [N]
        int, norms [N] float64)``; each row's difference from ``gvec`` and
        its square sum in float64."""
        counts = (~torch.isfinite(mat)).sum(dim=1)
        g64 = gvec.to(torch.float64)
        sq = torch.stack([torch.dot(d, d) for d in (row.to(torch.float64) - g64
                                                     for row in mat)])
        return _host(counts).astype(np.int64), np.sqrt(_host(sq))

    def clip(self, mat: torch.Tensor, gvec: torch.Tensor, factors: np.ndarray
             ) -> torch.Tensor:
        """Apply per-row clip factors (1.0 = untouched, verbatim): a clipped
        row is ``g + f * (row - g)`` in float64, rounded once to float32, as
        the numpy gate computes it."""
        out = mat.clone()
        g64 = gvec.to(torch.float64)
        for i, f in enumerate(np.asarray(factors, np.float64)):
            if f != 1.0:
                out[i] = (g64 + float(f) * (mat[i].to(torch.float64) - g64)).to(torch.float32)
        return out

    # ---- estimators ----------------------------------------------------
    def weighted_mean_vec(self, stacked: StackedRound) -> np.ndarray:
        """The float32 plane's weighted mean, bitwise numpy's chain
        ``sum(w * s[k] for ...) / round_weight`` (see the module
        docstring): eager ``mul`` and ``add`` kernels per row, no fused
        multiply-add, and a division by a device tensor."""
        mat, dev = stacked.mat, stacked.mat.device
        acc = torch.zeros(mat.shape[1], dtype=torch.float32, device=dev)
        for w, row in zip(stacked.weights, mat):
            acc = acc + torch.tensor(np.float32(w), device=dev) * row
        total = torch.tensor(np.float32(float(sum(stacked.weights))), device=dev)
        return _host(acc / total)

    @staticmethod
    def _sorted(stacked: StackedRound) -> torch.Tensor:
        """The plane sorted along the client axis (NaN last, as numpy's
        partition puts it)."""
        return torch.sort(stacked.mat, dim=0).values

    def trimmed_mean_vec(self, stacked: StackedRound, t: int) -> np.ndarray:
        n = len(stacked)
        return _host(self._sorted(stacked)[t:n - t].mean(dim=0))

    def median_vec(self, stacked: StackedRound) -> np.ndarray:
        s = self._sorted(stacked)
        n = s.shape[0]
        mid = s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2
        return _host(torch.where(torch.isnan(s[-1]), s[-1], mid))

    @staticmethod
    def _gram(rows: torch.Tensor) -> np.ndarray:
        r64 = rows.to(torch.float64)
        return _host(r64 @ r64.T)

    def krum_d2(self, stacked: StackedRound) -> np.ndarray:
        """Pairwise squared distances of the stacked rows through the gram
        identity (the numpy Krum's), as float32."""
        dots = self._gram(stacked.mat)
        sq = np.diagonal(dots).copy()
        d2 = sq[:, None] + sq[None, :] - 2.0 * dots
        return d2.astype(np.float32, copy=False)

    # ---- DP noise ------------------------------------------------------
    def noise_vector(self, plane: FlatPlane, *, std: float, seed: int,
                     index: int) -> np.ndarray:
        """``[plane.dim]`` float32 standard-normal draws times ``std``,
        made on the engine's device and returned to the host. The generator
        is seeded by :func:`noise_seed` of ``(seed, index)``: the same pair
        gives the same draws on the same device, and neighbouring indices
        give independent streams."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(noise_seed(seed, index))
        draws = torch.randn(plane.dim, generator=gen, dtype=torch.float32,
                            device=self.device)
        return _host(draws.mul_(float(np.float32(std))))

    def contribution_stats(
        self, stacked: StackedRound, avg: Mapping[str, Any]
    ) -> "tuple[np.ndarray, np.ndarray, float, float]":
        """Per-client contribution analytics on the stacked round: one gram
        over the update rows plus the flattened aggregate update, finished
        by :func:`~gfedntm_tpu_torch.federated.aggregation.contribution_from_gram`
        as the numpy oracle is."""
        from gfedntm_tpu_torch.federated.aggregation import contribution_from_gram

        gvec = stacked.gvec
        if gvec is None:
            raise ValueError(
                "StackedRound carries no current-global reference vector "
                "(gvec); contribution analytics need the admission gate's "
                "staged reference"
            )
        avg_vec = self.put_vector(stacked.plane, avg)
        g64 = gvec.to(torch.float64)
        rows = torch.cat([stacked.mat.to(torch.float64) - g64,
                          (avg_vec.to(torch.float64) - g64)[None]])
        return contribution_from_gram(_host(rows @ rows.T))


def stack_round(
    engine: DeviceAggEngine, plane: FlatPlane, pairs: list,
    current_global: "Mapping[str, Any] | None" = None,
) -> StackedRound:
    """Stack numpy-path ``[(weight, snapshot)]`` pairs into a device
    round; ``current_global`` also stages the reference vector the
    contribution analytics run against (:attr:`StackedRound.gvec`)."""
    snaps = [s for _w, s in pairs]
    return StackedRound(
        engine, plane, [w for w, _s in pairs],
        engine.stack(plane, snaps), snaps,
        gvec=(
            engine.put_vector(plane, current_global)
            if current_global is not None else None
        ),
    )


def _non_f32_weighted_mean(plane: FlatPlane, snapshots) -> dict:
    """numpy weighted-mean for the non-f32 remainder keys (preserves the
    numpy path's dtype semantics — e.g. int tensors average to float64)."""
    from gfedntm_tpu_torch.federated.aggregation import weighted_mean

    sub = [
        (w, {k: s[k] for k in plane.non_f32_keys}) for w, s in snapshots
    ]
    return weighted_mean(sub)


def estimate(estimator, stacked: StackedRound) -> dict[str, np.ndarray]:
    """Run ``estimator``'s mean stage on the device plane.

    Dispatches on the estimator type from ``aggregation.py``; every branch
    reproduces its numpy ``_estimate`` semantics (weighted mean bitwise in
    f32; trimmed mean / median / Krum to 1e-6, with identical Krum
    neighbor selection given non-degenerate scores).
    """
    from gfedntm_tpu_torch.federated import aggregation as agg

    plane, engine = stacked.plane, stacked.engine

    def _with_remainder(est: dict) -> dict:
        if plane.non_f32_keys:
            est.update(_non_f32_weighted_mean(plane, stacked.pairs))
        return est

    if isinstance(estimator, agg.Krum):
        n = len(stacked)
        if n - estimator.f < 2:
            # Cohort too small to score against itself — the numpy Krum
            # degrades to the median; mirror it.
            return estimate(agg.Median(), stacked)
        d2 = engine.krum_d2(stacked)
        chosen = agg.krum_select(d2, n, estimator.f)
        return estimate(agg.WeightedMean(), stacked.subset(chosen))
    if isinstance(estimator, agg.TrimmedMean):
        t = int(estimator.frac * len(stacked))
        vec = engine.trimmed_mean_vec(stacked, t)
        return plane.unflatten(vec)
    if isinstance(estimator, agg.Median):
        return plane.unflatten(engine.median_vec(stacked))
    if isinstance(estimator, agg.WeightedMean):
        vec = engine.weighted_mean_vec(stacked)
        est = plane.unflatten(vec, cast=False)
        # f32 keys are bitwise the numpy chain; non-f32 keys get the numpy
        # expression itself (weighted_mean does NOT cast back — int
        # tensors legitimately average to float64 there).
        for k in plane.non_f32_keys:
            del est[k]
        return _with_remainder(est)
    # Unknown estimator subtype: run its numpy implementation wholesale on
    # the retained host snapshots.
    return estimator._estimate(stacked.pairs)
