"""The federation's sample-weighted mean.

A copy of ``weighted_mean`` (``gfedntm_tpu/federation/aggregation.py:74-83``,
numpy only), kept here so the port never imports the JAX package. Its
expression and operand order are the original's, so FedAvg over the same
snapshots is the same bit for bit.
"""

from __future__ import annotations

import numpy as np


def weighted_mean(snapshots) -> dict[str, np.ndarray]:
    """``{key: sum_c w_c * s_c[key] / sum_c w_c}`` over ``snapshots``, a list
    of ``(weight, {key: array})`` pairs with the same keys."""
    round_weight = float(sum(w for w, _ in snapshots))
    keys = snapshots[0][1].keys()
    return {
        k: sum(w * s[k] for w, s in snapshots) / round_weight
        for k in keys
    }
