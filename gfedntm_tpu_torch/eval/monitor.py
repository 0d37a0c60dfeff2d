"""Live model-quality observability: the plane that watches the model.

A copy of ``gfedntm_tpu/eval/monitor.py``, kept here so the port never
imports the JAX package; it reads the port's :mod:`gfedntm_tpu_torch.eval.metrics`,
:mod:`gfedntm_tpu_torch.data.vocab`, :mod:`gfedntm_tpu_torch.data.synthetic`
and :mod:`gfedntm_tpu_torch.data.loaders`. ``tests/test_torch_quality_plane.py``
pins its source to the original's.

- :class:`TopicQualityMonitor`: on a round cadence (``quality_every``),
  each topic's top words from the global beta, NPMI coherence against a
  server-held reference corpus (``quality_ref``), topic diversity,
  inverted RBO, and round-over-round topic drift (topics matched by a
  Hungarian assignment on the cosine matrix, a greedy match without
  scipy; cosine drift, Jensen–Shannon divergence, churn). It emits
  ``quality_computed`` / ``topic_drift`` events and gauges, keeps a ring
  served as ``/status``'s ``model_quality``, and with ``quality_guard`` a
  sustained relative coherence drop is a ``coherence_collapse`` verdict
  that the server routes through its rollback.
- :class:`ContributionTracker`: per-client EWMAs of each admitted update's
  cosine to the accepted aggregate update and of its share of the
  cohort's update-norm mass, and the round's pairwise similarity summary;
  the gram behind them comes from
  :func:`gfedntm_tpu_torch.federated.aggregation.contribution_stats` or the
  device engine's ``contribution_stats``.

Nothing here runs unless the server enables the plane.
"""

from __future__ import annotations

import collections
import heapq
import logging
import threading
from typing import Any, Mapping, Sequence

import numpy as np

from gfedntm_tpu_torch.eval.metrics import (
    inverted_rbo,
    npmi_coherence,
    topic_diversity,
)

__all__ = [
    "COHERENCE_COLLAPSE",
    "softmax_rows",
    "find_beta_key",
    "topics_from_beta",
    "js_divergence_rows",
    "match_topics",
    "load_reference_corpus",
    "TopicQualityMonitor",
    "ContributionTracker",
]

#: Divergence reason code the quality guard feeds into the server's
#: rollback path (the `divergence_rollback` event vocabulary, alongside
#: train.guardian's loss/norm/nonfinite codes).
COHERENCE_COLLAPSE = "coherence_collapse"


def softmax_rows(mat: np.ndarray) -> np.ndarray:
    """Row softmax in float64 — the prodLDA topic-word distribution
    (:meth:`AVITM.get_topic_word_distribution` semantics on the raw
    beta; monotonic per row, so top-k word *ranking* is beta's)."""
    mat = np.asarray(mat, np.float64)
    e = np.exp(mat - mat.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def find_beta_key(average: Mapping[str, Any]) -> str:
    """The flattened shared-parameter key holding the topic-word matrix
    (``params/beta`` for AVITM/CTM; any ``*/beta`` leaf accepted)."""
    if "params/beta" in average:
        return "params/beta"
    for key in sorted(average):
        if key == "beta" or key.endswith("/beta"):
            return key
    raise KeyError(
        "no 'beta' tensor among the shared parameters "
        f"({sorted(average)[:5]}...): the quality monitor needs the "
        "topic-word matrix in the averaged subset"
    )


def topics_from_beta(
    beta: np.ndarray, id2token: Mapping[int, str], topn: int = 10
) -> list[list[str]]:
    """Top-``topn`` words per topic row (``AVITM.get_topics`` semantics,
    but from an arbitrary beta instead of model state)."""
    beta = np.asarray(beta)
    topn = min(int(topn), beta.shape[1])
    out = []
    for row in beta:
        idxs = np.argsort(-row)[:topn]
        out.append([id2token.get(int(j), str(int(j))) for j in idxs])
    return out


def js_divergence_rows(
    p: np.ndarray, q: np.ndarray, eps: float = 1e-12
) -> np.ndarray:
    """Row-wise Jensen–Shannon divergence of two ``[K, V]`` row-stochastic
    matrices, in bits (base 2 — bounded [0, 1])."""
    p = np.asarray(p, np.float64) + eps
    q = np.asarray(q, np.float64) + eps
    m = 0.5 * (p + q)
    kl_pm = np.sum(p * np.log2(p / m), axis=1)
    kl_qm = np.sum(q * np.log2(q / m), axis=1)
    return 0.5 * kl_pm + 0.5 * kl_qm


def _cosine_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    na = np.linalg.norm(a, axis=1, keepdims=True)
    nb = np.linalg.norm(b, axis=1, keepdims=True)
    return (a @ b.T) / np.maximum(na @ nb.T, 1e-30)


def match_topics(
    cur: np.ndarray, prev: np.ndarray, method: str = "hungarian"
) -> list[tuple[int, int, float]]:
    """Match current topics to the previous quality round's.

    Returns one ``(cur_idx, prev_idx, cosine)`` triple per current topic.
    ``hungarian`` solves the assignment exactly
    (``scipy.optimize.linear_sum_assignment`` on the negated cosine
    matrix, maximizing total similarity); ``greedy`` picks the globally
    best unmatched pair repeatedly — same answer on well-separated
    topics, and the dependency-free fallback when scipy is absent.
    """
    sim = _cosine_matrix(cur, prev)
    k_cur, k_prev = sim.shape
    if method == "hungarian":
        try:
            from scipy.optimize import linear_sum_assignment
        except ImportError:  # pragma: no cover - scipy is in the image
            method = "greedy"
        else:
            rows, cols = linear_sum_assignment(-sim)
            return sorted(
                (int(r), int(c), float(sim[r, c]))
                for r, c in zip(rows, cols)
            )
    if method != "greedy":
        raise ValueError(f"unknown match method {method!r}")
    matched: list[tuple[int, int, float]] = []
    used_cur: set[int] = set()
    used_prev: set[int] = set()
    order = np.argsort(-sim, axis=None)
    for flat in order:
        r, c = divmod(int(flat), k_prev)
        if r in used_cur or c in used_prev:
            continue
        used_cur.add(r)
        used_prev.add(c)
        matched.append((r, c, float(sim[r, c])))
        if len(used_cur) == k_cur or len(used_prev) == k_prev:
            break
    return sorted(matched)


def load_reference_corpus(path: str) -> list[list[str]]:
    """Load a server-held reference corpus (``--quality_ref``) as
    token lists for NPMI co-occurrence: a synthetic ``.npz`` archive
    (all nodes' documents), a ``.parquet`` corpus, or a plain text file
    (one document per line). Tokenization is the training analyzer
    (:func:`gfedntm_tpu_torch.data.vocab.tokenize`) so reference words live in
    the same token space as the federation vocabulary."""
    from gfedntm_tpu_torch.data.vocab import tokenize

    if path.endswith(".npz"):
        from gfedntm_tpu_torch.data.synthetic import load_reference_npz

        archive = load_reference_npz(path)
        docs = [d for node in archive.nodes for d in node.documents]
    elif path.endswith(".parquet"):
        from gfedntm_tpu_torch.data.loaders import load_parquet_corpus

        docs = load_parquet_corpus(path).documents
    else:
        with open(path) as fh:
            docs = [line.strip() for line in fh if line.strip()]
    corpus = [tokenize(d) for d in docs]
    if not corpus:
        raise ValueError(f"reference corpus {path!r} holds no documents")
    return corpus


class TopicQualityMonitor:
    """Per-round model-quality telemetry over the global topic model.

    Driven by the federation server's round loop: :meth:`should_run`
    gates on the cadence, :meth:`observe` digests one round's aggregate.
    State lives behind a lock because ``/status`` reads :meth:`status`
    from the ops-server thread while the training loop writes.

    Coherence guard (``--quality_guard`` routes its verdict): a round is
    *unhealthy* when NPMI sits more than ``guard_drop`` (relative, with
    an absolute floor ``guard_floor`` since NPMI can hover near 0) below
    its EWMA; the EWMA absorbs only healthy rounds, so decaying
    coherence cannot drag its own baseline down (the DivergenceGuardian
    recipe). ``guard_patience`` consecutive unhealthy quality rounds set
    :attr:`collapsed`; the server then runs the divergence-rollback path
    with reason ``coherence_collapse`` and calls :meth:`note_rollback`.
    """

    def __init__(
        self,
        *,
        every: int,
        id2token: Mapping[int, str],
        ref_tokens: "Sequence[Sequence[str]] | None" = None,
        topn: int = 10,
        history: int = 64,
        match: str = "hungarian",
        churn_cos: float = 0.5,
        guard_patience: int = 2,
        guard_drop: float = 0.5,
        guard_floor: float = 0.1,
        noise_floor: float = 0.0,
        metrics: Any = None,
        logger: logging.Logger | None = None,
    ):
        if every < 1:
            raise ValueError(f"quality cadence must be >= 1, got {every}")
        if topn < 2:
            raise ValueError(f"topn must be >= 2, got {topn}")
        if history < 1:
            raise ValueError(f"history must be >= 1, got {history}")
        if guard_patience < 1:
            raise ValueError(
                f"guard_patience must be >= 1, got {guard_patience}"
            )
        if guard_drop <= 0 or guard_floor <= 0:
            raise ValueError(
                "guard_drop/guard_floor must be > 0 (a zero threshold "
                "flags every fluctuation as a collapse)"
            )
        if noise_floor < 0:
            raise ValueError(
                f"noise_floor must be >= 0, got {noise_floor}"
            )
        self.every = int(every)
        self.id2token = dict(id2token)
        self.ref_tokens = (
            [list(doc) for doc in ref_tokens] if ref_tokens else None
        )
        self.topn = int(topn)
        self.match_method = match
        self.churn_cos = float(churn_cos)
        self.guard_patience = int(guard_patience)
        self.guard_drop = float(guard_drop)
        self.guard_floor = float(guard_floor)
        # DP-noise awareness (README "Differential privacy & posterior
        # sampling"): an additive NPMI slack on the collapse threshold.
        # With --dp on, every quality round's coherence jitters by the
        # injected noise; without the slack the guard reads that jitter
        # as decay and false-triggers rollbacks — but the slack is
        # ADDITIVE, not multiplicative, so a genuine collapse (a drop
        # far past the noise floor) still fires (regression-tested in
        # both directions).
        self.noise_floor = float(noise_floor)
        self.metrics = metrics
        self.logger = logger or logging.getLogger("TopicQualityMonitor")
        self._beta_key: str | None = None
        self._prev_dist: np.ndarray | None = None
        self._history: "collections.deque[dict]" = collections.deque(
            maxlen=int(history)
        )
        self._coherence_ewma: float | None = None
        self._streak = 0
        self._lock = threading.Lock()

    # ---- cadence + guard state ---------------------------------------------
    def should_run(self, round_idx: int) -> bool:
        return round_idx % self.every == 0

    @property
    def collapsed(self) -> bool:
        """True once ``guard_patience`` consecutive quality rounds showed
        a sustained relative coherence drop — the server's cue to run the
        divergence-rollback path with reason ``coherence_collapse``."""
        with self._lock:
            return self._streak >= self.guard_patience

    def note_rollback(self) -> None:
        """Reset the guard baseline AND the drift reference after the
        server restored a checkpoint: both describe the collapsed
        trajectory, not the restored one."""
        with self._lock:
            self._coherence_ewma = None
            self._streak = 0
            self._prev_dist = None

    # ---- per-round observation ---------------------------------------------
    def observe(
        self, round_idx: int, average: Mapping[str, np.ndarray]
    ) -> dict[str, Any]:
        """Digest one quality round's global average: compute coherence /
        diversity / drift, emit telemetry, append to the ring buffer, and
        update the guard streak. Returns the ring-buffer record."""
        if self._beta_key is None:
            self._beta_key = find_beta_key(average)
        beta = np.asarray(average[self._beta_key])
        dist = softmax_rows(beta)
        topics = topics_from_beta(beta, self.id2token, self.topn)

        npmi = (
            float(npmi_coherence(topics, self.ref_tokens, topn=self.topn))
            if self.ref_tokens is not None else None
        )
        diversity = float(topic_diversity(topics, topn=self.topn))
        irbo = float(inverted_rbo(topics, topn=self.topn))

        drift: dict[str, Any] | None = None
        with self._lock:
            prev = self._prev_dist
        if prev is not None and prev.shape == dist.shape:
            matches = match_topics(dist, prev, self.match_method)
            cos = np.array([c for _r, _c, c in matches])
            js = js_divergence_rows(
                dist[[r for r, _c, _cos in matches]],
                prev[[c for _r, c, _cos in matches]],
            )
            churned = int(np.sum(cos < self.churn_cos))
            drift = {
                "mean_drift": float(np.mean(1.0 - cos)),
                "max_drift": float(np.max(1.0 - cos)),
                "mean_js": float(np.mean(js)),
                "max_js": float(np.max(js)),
                "churn": churned,
                "matches": [
                    [int(r), int(c), float(v)] for r, c, v in matches
                ],
            }

        record: dict[str, Any] = {
            "round": int(round_idx),
            "npmi": npmi,
            "diversity": diversity,
            "irbo": irbo,
            "topn": self.topn,
            "n_topics": int(beta.shape[0]),
            "topics": topics,
        }
        if drift is not None:
            record["drift"] = {
                k: v for k, v in drift.items() if k != "matches"
            }

        m = self.metrics
        if m is not None:
            m.log(
                "quality_computed", round=int(round_idx), npmi=npmi,
                diversity=diversity, irbo=irbo, topn=self.topn,
                n_topics=int(beta.shape[0]), topics=topics,
            )
            reg = m.registry
            reg.counter("quality_rounds").inc()
            if npmi is not None:
                reg.gauge("quality_npmi").set(npmi)
            reg.gauge("quality_diversity").set(diversity)
            reg.gauge("quality_irbo").set(irbo)
            if drift is not None:
                m.log(
                    "topic_drift", round=int(round_idx),
                    mean_drift=drift["mean_drift"],
                    max_drift=drift["max_drift"],
                    mean_js=drift["mean_js"], max_js=drift["max_js"],
                    churn=drift["churn"], matches=drift["matches"],
                )
                reg.gauge("quality_drift_mean").set(drift["mean_drift"])
                reg.gauge("quality_drift_max").set(drift["max_drift"])
                reg.gauge("quality_churn").set(drift["churn"])
                if drift["churn"]:
                    reg.counter("topics_churned").inc(drift["churn"])

        self._observe_guard(npmi, round_idx)
        with self._lock:
            self._prev_dist = dist
            self._history.append(record)
        return record

    def _observe_guard(self, npmi: float | None, round_idx: int) -> None:
        """Fold one quality round's coherence into the guard EWMA/streak
        (no-op without a reference corpus — there is no coherence signal
        to guard)."""
        if npmi is None:
            return
        with self._lock:
            ewma = self._coherence_ewma
            threshold = (
                None if ewma is None
                else self.guard_drop * max(abs(ewma), self.guard_floor)
                + self.noise_floor
            )
            if threshold is not None and (ewma - npmi) > threshold:
                self._streak += 1
                streak = self._streak
            else:
                self._streak = 0
                streak = 0
                self._coherence_ewma = (
                    npmi if ewma is None else 0.7 * ewma + 0.3 * npmi
                )
        if streak:
            self.logger.warning(
                "round %d: topic coherence %.3f sits %.3f below its EWMA "
                "%.3f — unhealthy quality round %d/%d",
                round_idx, npmi, ewma - npmi, ewma, streak,
                self.guard_patience,
            )
            if self.metrics is not None:
                self.metrics.registry.counter(
                    "unhealthy_quality_rounds"
                ).inc()

    # ---- ops endpoint view --------------------------------------------------
    def status(self) -> dict[str, Any]:
        """JSON-safe view for ``/status``'s ``model_quality`` key: the
        cadence, guard state, last record, and the bounded history ring
        (topics elided from history rows to keep the payload small)."""
        with self._lock:
            history = [
                {k: v for k, v in rec.items() if k != "topics"}
                for rec in self._history
            ]
            last = dict(self._history[-1]) if self._history else None
            return {
                "every": self.every,
                "topn": self.topn,
                "has_reference": self.ref_tokens is not None,
                "noise_floor": self.noise_floor,
                "coherence_ewma": self._coherence_ewma,
                "unhealthy_streak": self._streak,
                "last": last,
                "history": history,
            }


class ContributionTracker:
    """Per-client contribution EWMAs over each round's admitted cohort.

    :meth:`observe_round` folds in one round's cosine-to-aggregate and
    norm-share vectors (row-aligned with the admitted client ids — the
    gram math lives in ``aggregation.contribution_stats`` and the device
    engine); gauges ``client_contribution_cos/<cid>`` and
    ``client_contribution_share/<cid>`` export the EWMAs, and the
    round's pairwise summary lands in ``contribution_pairwise_cos_mean``
    / ``_min`` (the non-IID dispersion signal). :meth:`forget` evicts a
    departed client's state AND its gauges — per-client series must not
    grow without bound under churn (README "Model-quality
    observability")."""

    def __init__(self, registry: Any = None, alpha: float = 0.3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.registry = registry
        self.alpha = float(alpha)
        self._cos: dict[Any, float] = {}
        self._share: dict[Any, float] = {}
        self._rounds: dict[Any, int] = {}
        self._pair_mean: float | None = None
        self._pair_min: float | None = None
        self._lock = threading.Lock()

    def observe_round(
        self,
        round_idx: int,
        client_ids: Sequence[Any],
        cos_to_agg: np.ndarray,
        norms: np.ndarray,
        pair_mean: float,
        pair_min: float,
    ) -> None:
        norms = np.asarray(norms, np.float64)
        total = float(norms.sum())
        shares = norms / total if total > 0 else np.zeros_like(norms)
        with self._lock:
            for cid, cos, share in zip(client_ids, cos_to_agg, shares):
                cos, share = float(cos), float(share)
                prev_cos = self._cos.get(cid)
                prev_share = self._share.get(cid)
                self._cos[cid] = (
                    cos if prev_cos is None
                    else self.alpha * cos + (1 - self.alpha) * prev_cos
                )
                self._share[cid] = (
                    share if prev_share is None
                    else self.alpha * share + (1 - self.alpha) * prev_share
                )
                self._rounds[cid] = self._rounds.get(cid, 0) + 1
                if self.registry is not None:
                    self.registry.gauge(
                        f"client_contribution_cos/client{cid}"
                    ).set(self._cos[cid])
                    self.registry.gauge(
                        f"client_contribution_share/client{cid}"
                    ).set(self._share[cid])
            self._pair_mean = (
                float(pair_mean) if np.isfinite(pair_mean) else None
            )
            self._pair_min = (
                float(pair_min) if np.isfinite(pair_min) else None
            )
        if self.registry is not None:
            if self._pair_mean is not None:
                self.registry.gauge(
                    "contribution_pairwise_cos_mean"
                ).set(self._pair_mean)
            if self._pair_min is not None:
                self.registry.gauge(
                    "contribution_pairwise_cos_min"
                ).set(self._pair_min)

    def forget(self, client_id: Any) -> None:
        """Evict a departed client's EWMAs and DROP its gauges from the
        registry — the per-client series cardinality guard (a rejoin
        re-warms from scratch, like the straggler detector)."""
        with self._lock:
            self._cos.pop(client_id, None)
            self._share.pop(client_id, None)
            self._rounds.pop(client_id, None)
        if self.registry is not None:
            self.registry.drop(f"client_contribution_cos/client{client_id}")
            self.registry.drop(
                f"client_contribution_share/client{client_id}"
            )

    def status(self) -> dict[str, Any]:
        """JSON-safe per-client view for the ops endpoint."""
        with self._lock:
            return {
                "clients": {
                    str(cid): {
                        "cos_ewma": self._cos[cid],
                        "share_ewma": self._share.get(cid),
                        "rounds": self._rounds.get(cid, 0),
                    }
                    for cid in sorted(self._cos, key=str)
                },
                "pairwise_cos_mean": self._pair_mean,
                "pairwise_cos_min": self._pair_min,
            }

    def summary(self, top_k: int = 5) -> dict[str, Any]:
        """Bounded view for the default ``/status`` scrape: the ``top_k``
        least-aligned contributors (the ones an operator actually looks
        for) plus the total, without materializing 10⁴ per-client EWMA
        dicts the way :meth:`status` does."""
        with self._lock:
            worst = heapq.nsmallest(
                top_k, self._cos.items(),
                key=lambda kv: (
                    kv[1] if kv[1] is not None else 1.0, str(kv[0])
                ),
            )
            return {
                "clients": {
                    str(cid): {
                        "cos_ewma": cos,
                        "share_ewma": self._share.get(cid),
                        "rounds": self._rounds.get(cid, 0),
                    }
                    for cid, cos in worst
                },
                "clients_total": len(self._cos),
                "pairwise_cos_mean": self._pair_mean,
                "pairwise_cos_min": self._pair_min,
            }
