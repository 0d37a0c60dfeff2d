"""RDP/moments (ε, δ) accountant for the federated DP mechanisms.

A copy of ``gfedntm_tpu/privacy/accountant.py`` (pure Python and
``math``), kept here so the port never imports the JAX package;
``tests/test_torch_privacy.py`` pins its source to the original's.

The ledger tracks Rényi differential privacy at the integer orders
α ∈ [2, 64] and converts to (ε, δ) on demand: one Gaussian mechanism
application with noise multiplier σ costs ``α / (2σ²)`` at order α
(Mironov 2017), a round subsampled with inclusion probability q < 1 costs
the exact integer-α subsampled-Gaussian bound (Mironov–Talwar–Zhang 2019),
rounds compose by adding the per-order RDP, and
``ε(δ) = min_α [rdp(α) + log(1/δ)/(α−1)]``. Sync pacing charges q = 1.
:meth:`PrivacyAccountant.state_dict` rides the server's journal and
checkpoints, so a recovered run resumes its spent budget.
"""

from __future__ import annotations

import math
from typing import Any

__all__ = [
    "ALPHAS",
    "gaussian_rdp",
    "subsampled_gaussian_rdp",
    "eps_from_rdp",
    "PrivacyAccountant",
]

#: Integer Rényi orders tracked by the ledger. 2..64 brackets the
#: optimal order for every (σ, δ) regime the knobs can express: small σ
#: optimizes at low α, large σ at α ≈ 1 + σ·sqrt(2 log(1/δ)).
ALPHAS: tuple[int, ...] = tuple(range(2, 65))


def gaussian_rdp(alpha: float, sigma: float) -> float:
    """RDP of one Gaussian mechanism application at order ``alpha`` with
    noise multiplier ``sigma`` (std = sigma × L2 sensitivity)."""
    if sigma <= 0.0:
        return math.inf
    return float(alpha) / (2.0 * sigma * sigma)


def _log_comb(n: int, k: int) -> float:
    return (
        math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)
    )


def _logsumexp(terms: "list[float]") -> float:
    hi = max(terms)
    if hi == -math.inf:
        return -math.inf
    return hi + math.log(sum(math.exp(t - hi) for t in terms))


def subsampled_gaussian_rdp(alpha: int, q: float, sigma: float) -> float:
    """RDP at integer order ``alpha`` of one subsampled-Gaussian round
    with inclusion probability ``q``: the exact binomial-expansion bound
    (valid for integer α ≥ 2), clamped at the non-subsampled cost so a
    numerically-degenerate q can never *under*-charge."""
    if sigma <= 0.0:
        return math.inf
    full = gaussian_rdp(alpha, sigma)
    if q >= 1.0:
        return full
    if q <= 0.0:
        return 0.0
    a = int(alpha)
    c = 1.0 / (2.0 * sigma * sigma)
    terms = [
        _log_comb(a, j)
        + (a - j) * math.log1p(-q)
        + j * math.log(q)
        + j * (j - 1) * c
        for j in range(a + 1)
    ]
    bound = max(0.0, _logsumexp(terms) / (a - 1))
    return min(bound, full)


def eps_from_rdp(
    rdp: "dict[int, float]", delta: float
) -> "tuple[float, int]":
    """Convert an RDP curve to (ε, best order) at the given δ."""
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    log_inv = math.log(1.0 / delta)
    best_eps, best_alpha = math.inf, 0
    for alpha, r in rdp.items():
        eps = r + log_inv / (alpha - 1)
        if eps < best_eps:
            best_eps, best_alpha = eps, int(alpha)
    return float(best_eps), best_alpha


class PrivacyAccountant:
    """The per-run (ε, δ) ledger: one :meth:`step` per aggregation round
    that actually applied a mechanism, composed in RDP, converted to
    (ε, δ) on demand. Budget exhaustion flips :attr:`exceeded` but never
    stops training — the offline ``privacy`` CLI gate is the enforcement
    point (as the ``slo`` gate is for SLOs)."""

    def __init__(
        self,
        *,
        sigma: float,
        delta: float = 1e-5,
        budget: float = 0.0,
        mode: str = "server",
    ):
        if sigma <= 0.0:
            raise ValueError(
                f"accountant needs a positive noise multiplier, got {sigma}"
            )
        if not 0.0 < delta < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {delta}")
        self.sigma = float(sigma)
        self.delta = float(delta)
        #: Declared ε budget; 0 means "track only, no declared budget".
        self.budget = float(budget)
        self.mode = str(mode)
        self.steps = 0
        self.last_q = 1.0
        self._rdp: dict[int, float] = {a: 0.0 for a in ALPHAS}

    # ---- composition ---------------------------------------------------
    def step(self, q: float = 1.0, sigma: "float | None" = None) -> float:
        """Charge one mechanism application with inclusion probability
        ``q`` (1.0 = every eligible client participated — the
        conservative default for sync/async/push pacing); returns the
        spent ε at the ledger's δ."""
        s = self.sigma if sigma is None else float(sigma)
        q = min(1.0, max(0.0, float(q)))
        for alpha in ALPHAS:
            self._rdp[alpha] += subsampled_gaussian_rdp(alpha, q, s)
        self.steps += 1
        self.last_q = q
        return self.epsilon()

    def epsilon(self, delta: "float | None" = None) -> float:
        """Spent ε at ``delta`` (default: the ledger's δ)."""
        if self.steps == 0:
            return 0.0
        eps, _ = eps_from_rdp(
            self._rdp, self.delta if delta is None else float(delta)
        )
        return eps

    @property
    def exceeded(self) -> bool:
        return self.budget > 0.0 and self.epsilon() > self.budget

    # ---- persistence (rides the checkpoint/journal extra state) --------
    def state_dict(self) -> "dict[str, Any]":
        return {
            "version": 1,
            "mode": self.mode,
            "sigma": self.sigma,
            "delta": self.delta,
            "budget": self.budget,
            "steps": int(self.steps),
            "last_q": float(self.last_q),
            # JSON keys are strings; keep the grid explicit so a future
            # ALPHAS change cannot silently misalign a restored ledger.
            "rdp": {str(a): float(v) for a, v in self._rdp.items()},
        }

    def load_state_dict(self, state: "dict[str, Any]") -> None:
        if int(state.get("version", 1)) != 1:
            raise ValueError(
                f"unknown privacy ledger version {state.get('version')!r}"
            )
        self.steps = int(state["steps"])
        self.last_q = float(state.get("last_q", 1.0))
        rdp = {int(a): float(v) for a, v in dict(state["rdp"]).items()}
        # A restored ledger keeps ITS grid values for orders we track;
        # orders the snapshot lacks restart at the conservative maximum
        # already spent (never below — the budget must not reset).
        fallback = max(rdp.values(), default=0.0)
        self._rdp = {a: rdp.get(a, fallback) for a in ALPHAS}

    # ---- surfacing -----------------------------------------------------
    def status(self) -> "dict[str, Any]":
        eps = self.epsilon()
        return {
            "mode": self.mode,
            "eps": eps,
            "delta": self.delta,
            "sigma": self.sigma,
            "steps": int(self.steps),
            "last_q": float(self.last_q),
            "budget": self.budget,
            "exceeded": bool(self.exceeded),
        }
