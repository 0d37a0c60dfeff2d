"""The first-step gradient parity of ``fit_sharded``'s network catches the
faults the V-sharded and the data-parallel paths invite, and those of the
unfused prodLDA and LDA decodes at mp > 1 (``DECODE_MUTATIONS``, at dp=2 x
mp=2: theta's decode gradient not summed over the model group, the merged
softmax's sum with an identity backward, LDA's ``beta_batchnorm`` synced
over the data group), and those of a CombinedTM with labels at dp=2 x mp=2
(``CTM_MUTATIONS``: the label columns' product added on every rank of the
model group, the label cross-entropy divided by the rank's own count of
real rows, ``adapt_bert`` held whole on every rank instead of split).

Each case breaks one convention inside two spawned gloo ranks (dp=1, mp=2;
or dp=2, mp=1 for the data-parallel faults) and computes the fused training
loss and every parameter's gradient on the first batch
(``programs.step_gradients``), gathered to full shapes, and for the
data-parallel cases the BatchNorm buffers after the step; the unbroken run
is the control. The parity thresholds are those of
``tests/test_torch_sharded_fit.py::test_first_step_gradients_match_unsharded``:
loss within 1e-6 relative of the unsharded network's, each gradient within
5e-4 x its max|grad|, gradients that are zero in exact arithmetic within
1e-5 x the largest gradient; the buffers within 1e-4 of their max (the
counter exactly). This module imports only torch, numpy and the port, so
the ranks can import its rank programs.
"""

import contextlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F

from gfedntm_tpu_torch.models import layers, losses, networks
from gfedntm_tpu_torch.models.avitm import AVITM
from gfedntm_tpu_torch.models.ctm import CTM
from gfedntm_tpu_torch.ops import fused_decoder as fd
from gfedntm_tpu_torch.parallel import collectives, programs, sharded
from gfedntm_tpu_torch.parallel.collectives import gather_by_sum, sum_forward_identity_backward
from gfedntm_tpu_torch.parallel.launch import run_ranks
from gfedntm_tpu_torch.parallel.mesh import make_dp_mp_groups
from gfedntm_tpu_torch.train import steps as train_steps

V, K, H, B, DOCS, MP, DP = 96, 4, (16, 16), 8, 32, 2, 2
KW = dict(input_size=V, n_components=K, hidden_sizes=H, batch_size=B, num_epochs=1,
          dropout=0.0, seed=0, fused_decoder=True)
DEGENERATE = ("inf_net.f_mu.bias", "inf_net.f_sigma.bias", "prior_mean")
TIMEOUT_S = 240


def _all_reduced_grad(t, group):
    """The naive sum: ``torch.distributed.nn``'s all_reduce, whose backward
    all-reduces the gradient too."""
    return dist_fn.all_reduce(t, group=group)


def _bias_before_sum(self, x_local):
    return sharded.sum_forward_identity_backward(F.linear(x_local, self.weight, self.bias),
                                                 self.group)


def _g_theta_unsummed(real):
    """K5's sums with the backward's [B, K] g_theta sum skipped (the forward
    sums a [2, B] stack of the loss and row-dot partials)."""
    def patched(t, group):
        return real(t, group) if t.shape[0] == 2 else t
    return patched


def _merge_unrescaled(m_loc, s_loc, group):
    """The softmax merge without the ``exp(m_i - m)`` rescale of each shard's
    denominator."""
    parts = gather_by_sum(torch.stack([m_loc, s_loc]), group)
    return parts[:, 0].amax(dim=0).contiguous(), parts[:, 1].sum(dim=0).contiguous()


MUTATIONS = {  # name: [(object, attribute, replacement)]
    "none": [],
    "input_sum_all_reduces_grad": [(sharded, "sum_forward_identity_backward",
                                    _all_reduced_grad)],
    "bias_added_on_every_rank": [(sharded.VShardedLinear, "forward", _bias_before_sum)],
    "g_theta_unsummed": [(fd, "sum_in_rank_order", _g_theta_unsummed(fd.sum_in_rank_order))],
    "softmax_merge_unrescaled": [(fd, "merge_softmax", _merge_unrescaled)],
}


def _local_count(real):
    """The whole batch's count with the data group dropped: the local one."""
    def patched(mask, group):
        return real(mask, None)
    return patched


def _not_summed(model, data_group):
    """Each data rank steps on its own rows' gradients."""


DP_MUTATIONS = {
    "none": [],
    "batchnorm_identity_backward": [(layers, "sum_forward_sum_backward",
                                     sum_forward_identity_backward)],
    "running_var_local_count": [(train_steps, "batch_count",
                                 _local_count(train_steps.batch_count))],
    "gradients_not_summed": [(train_steps, "sum_gradients", _not_summed),
                             (programs, "sum_gradients", _not_summed)],
}


def _theta_grad_unsummed(t, group):
    """Theta enters the decode as is: each rank keeps only its own columns'
    part of theta's decode gradient."""
    return t


def _lda_batchnorm_on_the_data_group(self, group):
    """``set_data_group`` that also syncs LDA's ``beta_batchnorm``, which
    normalizes the replicated beta and must stay local."""
    self.inf_net.f_mu_batchnorm.group = group
    self.inf_net.f_sigma_batchnorm.group = group
    self.beta_batchnorm.group = group


@staticmethod
def _softmax_backward_unsummed(ctx, grad):
    """The merged softmax's backward with the rows' dot ``sum_v g y`` of
    the rank's own columns only: the sum ``S`` with an identity backward."""
    y, = ctx.saved_tensors
    yf, gf = y.float(), grad.float()
    return (yf * (gf - (gf * yf).sum(dim=1)[:, None])).to(grad.dtype), None


DECODE_KW = {model_type: {**KW, "fused_decoder": False, "model_type": model_type,
                          "n_components": 6}
             for model_type in ("prodLDA", "LDA")}
DECODE_MUTATIONS = {
    "none": [],
    "theta_grad_unsummed": [(networks, "identity_forward_sum_backward",
                             _theta_grad_unsummed)],
    "softmax_sum_identity_backward": [(collectives._SoftmaxOverGroup, "backward",
                                       _softmax_backward_unsummed)],
    "lda_batchnorm_on_the_data_group": [(networks.DecoderNetwork, "set_data_group",
                                         _lda_batchnorm_on_the_data_group)],
}


CTM_KW = {**KW, "n_components": 6, "inference_type": "combined", "contextual_size": 12,
          "label_size": 3}


def _label_rows_inside_the_sum(self, x_local):
    """The input layer with the label columns' product inside the sum over
    the model group: counted mp times."""
    return sum_forward_identity_backward(F.linear(x_local, self.weight), self.group) + self.bias


class _WholeAdaptBert(layers.Linear):
    """``adapt_bert`` held whole on the rank, its output cut to the rank's
    columns: the forward is right, but each rank's gradient reaches only
    its own rows, and nothing sums them over the model group."""

    def __init__(self, full, cols):
        super().__init__(full.in_features, full.out_features, full.compute_dtype)
        self.load_state_dict(full.state_dict())
        self.cols = cols

    def forward(self, x):
        return super().forward(x)[:, self.cols]


def _adapt_bert_replicated(real):
    def patched(network, groups):
        local = real(network, groups)
        local.inf_net.adapt_bert = _WholeAdaptBert(local.inf_net.adapt_bert,
                                                   groups.v_slice(network.beta.shape[1]))
        return local
    return patched


CTM_MUTATIONS = {
    "none": [],
    "label_rows_on_every_rank": [(sharded.VShardedLinear, "forward",
                                  _label_rows_inside_the_sum)],
    "label_ce_local_count": [(losses, "batch_count", _local_count(losses.batch_count))],
    "adapt_bert_replicated": [
        (sharded, "SPLITS", {**sharded.SPLITS, "combined": {
            k: v for k, v in sharded.SPLITS["combined"].items() if "adapt_bert" not in k}}),
        (sharded, "local_network", _adapt_bert_replicated(sharded.local_network)),
        (programs, "local_network", _adapt_bert_replicated(sharded.local_network)),
    ],
}


def ctm_corpus() -> dict:
    rng = np.random.default_rng(1)
    return {"X": rng.integers(0, 3, size=(DOCS, V)).astype(np.float32),
            "X_ctx": rng.normal(size=(DOCS, 12)).astype(np.float32),
            "labels": np.eye(3, dtype=np.float32)[rng.integers(0, 3, DOCS)]}


@contextlib.contextmanager
def mutated(name, table=MUTATIONS):
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in table[name]]
    for obj, attr, value in table[name]:
        setattr(obj, attr, value)
    try:
        yield
    finally:
        for obj, attr, value in saved:
            setattr(obj, attr, value)


def first_steps_under_mutations(rank, device, X):
    """Rank program: ``{mutation: (loss, full gradients)}`` of the first
    step of an identically seeded model, each under its mutation."""
    groups = make_dp_mp_groups(1, MP)
    out = {}
    for name in MUTATIONS:
        with mutated(name):
            out[name] = programs.step_gradients(AVITM(device=device, **KW), X, groups)
    return out


def first_steps_dp_mutations(rank, device, X):
    """Rank program: ``{mutation: (loss, full gradients, BatchNorm
    buffers)}`` of the first step at dp=2, each under its mutation."""
    groups = make_dp_mp_groups(DP, 1)
    out = {}
    for name in DP_MUTATIONS:
        with mutated(name, DP_MUTATIONS):
            out[name] = programs.step_gradients(AVITM(device=device, **KW), X, groups,
                                                with_stats=True)
    return out


def first_steps_decode_mutations(rank, device, X):
    """Rank program: ``{(model type, mutation): (loss, full gradients,
    BatchNorm buffers)}`` of the first step of the unfused decodes at dp=2 x
    mp=2, each under its mutation."""
    groups = make_dp_mp_groups(DP, MP)
    out = {}
    for model_type, kw in DECODE_KW.items():
        for name in DECODE_MUTATIONS:
            with mutated(name, DECODE_MUTATIONS):
                out[model_type, name] = programs.step_gradients(AVITM(device=device, **kw), X,
                                                                groups, with_stats=True)
    return out


def first_steps_ctm_mutations(rank, device, X):
    """Rank program: ``{mutation: (loss, full gradients, BatchNorm
    buffers)}`` of a CombinedTM's first step at dp=2 x mp=2, each under its
    mutation."""
    groups = make_dp_mp_groups(DP, MP)
    out = {}
    for name in CTM_MUTATIONS:
        with mutated(name, CTM_MUTATIONS):
            out[name] = programs.step_gradients(CTM(device=device, **CTM_KW), X, groups,
                                                with_stats=True)
    return out


def parity_failures(step, ref) -> set:
    """The names (``"loss"``, a parameter or a BatchNorm buffer) that fail
    the parity check."""
    (loss, grads), (ref_loss, ref_grads) = step[:2], ref[:2]
    failed = set() if loss == pytest.approx(ref_loss, rel=1e-6) else {"loss"}
    if len(step) == 3:
        for name, want in ref[2].items():
            got = step[2][name]
            if want.dtype.kind != "f":
                bad = not np.array_equal(got, want)
            else:
                bad = float(np.abs(got - want).max()) > 1e-4 * max(1.0, float(np.abs(want).max()))
            if bad:
                failed.add(name)
    scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    for name, want in ref_grads.items():
        if name in DEGENERATE:
            bad = float(np.abs(grads[name]).max()) > 1e-5 * scale
        else:
            bad = float(np.abs(grads[name] - want).max()) >= 5e-4 * float(np.abs(want).max())
        if bad:
            failed.add(name)
    return failed


@pytest.fixture(scope="module")
def steps():
    X = np.random.default_rng(0).integers(0, 3, size=(DOCS, V)).astype(np.float32)
    ref = programs.step_gradients(AVITM(device="cpu", **KW), X, with_stats=True)
    with ThreadPoolExecutor(2) as pool:
        mp_ranks = pool.submit(run_ranks, first_steps_under_mutations, MP, "gloo",
                               ["cpu"] * MP, TIMEOUT_S, (X,))
        dp_ranks = pool.submit(run_ranks, first_steps_dp_mutations, DP, "gloo",
                               ["cpu"] * DP, TIMEOUT_S, (X,))
        return ref, mp_ranks.result(), dp_ranks.result()


@pytest.fixture(scope="module")
def decode_steps():
    X = np.random.default_rng(0).integers(0, 3, size=(DOCS, V)).astype(np.float32)
    refs = {model_type: programs.step_gradients(AVITM(device="cpu", **kw), X, with_stats=True)
            for model_type, kw in DECODE_KW.items()}
    return refs, run_ranks(first_steps_decode_mutations, DP * MP, "gloo", ["cpu"] * (DP * MP),
                           TIMEOUT_S, (X,))


def test_the_unbroken_ranks_pass_the_parity_check(steps):
    ref, ranks, dp_ranks = steps
    for r in ranks:
        assert parity_failures(r["none"], ref[:2]) == set()
    for r in dp_ranks:
        assert parity_failures(r["none"], ref) == set()


@pytest.mark.parametrize("mutation, caught_by", [
    ("input_sum_all_reduces_grad", {"inf_net.input_layer.weight"}),
    ("bias_added_on_every_rank", {"loss"}),
    ("g_theta_unsummed", {"inf_net.input_layer.weight", "inf_net.f_mu.weight"}),
    ("softmax_merge_unrescaled", {"loss"}),
])
def test_each_mutation_fails_the_parity_check(steps, mutation, caught_by):
    ref, ranks, _ = steps
    for r in ranks:
        assert caught_by <= parity_failures(r[mutation], ref[:2]), mutation


@pytest.mark.parametrize("mutation, caught_by", [
    ("batchnorm_identity_backward", {"inf_net.f_mu.weight", "inf_net.f_sigma.weight"}),
    ("running_var_local_count", {"beta_batchnorm.running_var"}),
    ("gradients_not_summed", {"beta", "inf_net.input_layer.weight", "prior_variance"}),
])
def test_each_data_parallel_mutation_fails_the_parity_check(steps, mutation, caught_by):
    ref, _, dp_ranks = steps
    for r in dp_ranks:
        assert caught_by <= parity_failures(r[mutation], ref), mutation


@pytest.mark.parametrize("model_type", sorted(DECODE_KW))
def test_the_unbroken_decode_ranks_pass_the_parity_check(decode_steps, model_type):
    refs, ranks = decode_steps
    for r in ranks:
        assert parity_failures(r[model_type, "none"], refs[model_type]) == set()


@pytest.mark.parametrize("model_type, mutation, caught_by", [
    ("prodLDA", "theta_grad_unsummed", {"inf_net.input_layer.weight", "inf_net.f_mu.weight"}),
    ("LDA", "theta_grad_unsummed", {"inf_net.input_layer.weight", "inf_net.f_mu.weight"}),
    ("prodLDA", "softmax_sum_identity_backward", {"beta"}),
    ("LDA", "softmax_sum_identity_backward", {"beta"}),
    ("LDA", "lda_batchnorm_on_the_data_group", {"beta_batchnorm.running_var"}),
])
def test_each_decode_mutation_fails_the_parity_check(decode_steps, model_type, mutation,
                                                      caught_by):
    refs, ranks = decode_steps
    for r in ranks:
        assert caught_by <= parity_failures(r[model_type, mutation], refs[model_type]), mutation


@pytest.fixture(scope="module")
def ctm_steps():
    X = ctm_corpus()
    ref = programs.step_gradients(CTM(device="cpu", **CTM_KW), X, with_stats=True)
    return ref, run_ranks(first_steps_ctm_mutations, DP * MP, "gloo", ["cpu"] * (DP * MP),
                          TIMEOUT_S, (X,))


def test_the_unbroken_ctm_ranks_pass_the_parity_check(ctm_steps):
    ref, ranks = ctm_steps
    for r in ranks:
        assert parity_failures(r["none"], ref) == set()


@pytest.mark.parametrize("mutation, caught_by", [
    ("label_rows_on_every_rank", {"loss", "inf_net.input_layer.weight"}),
    ("label_ce_local_count", {"loss", "label_classification.weight"}),
    ("adapt_bert_replicated", {"inf_net.adapt_bert.weight", "inf_net.adapt_bert.bias"}),
])
def test_each_ctm_mutation_fails_the_parity_check(ctm_steps, mutation, caught_by):
    ref, ranks = ctm_steps
    for r in ranks:
        assert caught_by <= parity_failures(r[mutation], ref), mutation
