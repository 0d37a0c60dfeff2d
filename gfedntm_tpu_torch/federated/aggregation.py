"""The federation's sample-weighted mean and its server-side strategy.

Copies from ``gfedntm_tpu/federation/aggregation.py`` (numpy only), kept
here so the port never imports the JAX package:

- ``weighted_mean`` (:74-83): its expression and operand order are the
  original's, so FedAvg over the same snapshots is the same bit for bit;
- ``ServerAggregator`` and ``FedAvg`` (:345-421), with the weighted mean as
  the one mean stage, and ``make_aggregator`` (:551), which the federation
  server calls.

The server optimizers (FedAvgM, FedAdam, FedYogi), the robust mean stages
(trimmed mean, median, Krum) and the device-resident mean are not ported
yet: asking for one raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

#: Strategies of the JAX package the port does not have yet (ROADMAP queue 1).
QUEUED = ("fedavgm", "fedadam", "fedyogi", "median", "trimmed_mean", "krum")


def weighted_mean(snapshots) -> dict[str, np.ndarray]:
    """``{key: sum_c w_c * s_c[key] / sum_c w_c}`` over ``snapshots``, a list
    of ``(weight, {key: array})`` pairs with the same keys."""
    round_weight = float(sum(w for w, _ in snapshots))
    keys = snapshots[0][1].keys()
    return {
        k: sum(w * s[k] for w, s in snapshots) / round_weight
        for k in keys
    }


class ServerAggregator:
    """One round's aggregate step: ``snapshots`` (per-client ``(weight,
    flat-snapshot)`` pairs, already decoded and key-validated) plus the
    server's ``current_global`` (the last broadcast average, or the
    template init before round 0) map to the new global parameters.

    The mean stage is the sample-weighted mean."""

    name = "base"

    def __init__(self, estimator: Any = None):
        if estimator not in (None, "mean"):
            raise NotImplementedError(
                f"robust mean stage {estimator!r} is not ported yet (ROADMAP queue 1)")

    def _mean(self, snapshots) -> dict[str, np.ndarray]:
        return weighted_mean(snapshots)

    def aggregate(
        self,
        snapshots,
        current_global: Mapping[str, np.ndarray],
    ) -> dict[str, np.ndarray]:
        raise NotImplementedError


class FedAvg(ServerAggregator):
    """The reference semantics: assign the sample-weighted mean."""

    name = "fedavg"

    def aggregate(self, snapshots, current_global=None):
        return self._mean(snapshots)


AGGREGATORS: dict[str, type] = {FedAvg.name: FedAvg}


def make_aggregator(
    spec: "str | ServerAggregator | None",
    robust: Any = None,
    **kwargs: Any,
) -> ServerAggregator:
    """Resolve a name (or pass through an instance) to an aggregator:
    ``fedavg``. A strategy of the JAX package that is not ported yet raises
    ``NotImplementedError``; an unknown name raises ``ValueError``."""
    if isinstance(spec, ServerAggregator):
        if kwargs or robust is not None:
            raise ValueError(
                "kwargs/robust are for by-name construction only"
            )
        return spec
    name = (spec or "fedavg").strip().lower()
    if robust is not None or name.partition(":")[0] in QUEUED:
        raise NotImplementedError(
            f"aggregator {name!r}"
            + (f" with robust={robust!r}" if robust is not None else "")
            + " is not ported yet (ROADMAP queue 1); the port runs fedavg")
    cls = AGGREGATORS.get(name)
    if cls is None:
        raise ValueError(
            f"unknown aggregator {name!r} (want one of {sorted(AGGREGATORS)})")
    if kwargs:
        raise ValueError(f"fedavg takes no server-optimizer kwargs ({sorted(kwargs)})")
    return cls()
