"""AVITM and CTM networks (ProdLDA / NeuralLDA decoders; BoW, contextual
and combined encoders) as ``nn.Module``s.

Counterpart of ``gfedntm_tpu/models/networks.py``:

- :class:`InferenceNetwork` <- ``InferenceNetwork`` (``networks.py:51-79``),
  itself the reference's ``inference_network.py:7-85``;
- :class:`ContextualInferenceNetwork` (ZeroShotTM) <-
  ``ContextualInferenceNetwork`` (``networks.py:82-113``): its input layer
  reads ``[x_ctx | labels]``;
- :class:`CombinedInferenceNetwork` (CombinedTM) <-
  ``CombinedInferenceNetwork`` (``networks.py:116-153``): ``adapt_bert``
  maps the contextual embedding to V, and the input layer reads
  ``[x_bow | adapt_bert(x_ctx) | labels]``;
- :class:`DecoderNetwork`   <- ``DecoderNetwork`` (``networks.py:156-360``),
  with ``inference_type`` choosing the encoder and, when ``label_size`` is
  set, the label head ``label_classification`` (K -> L) on theta.

The labels join the encoder's input whenever they are given
(``labels is not None``: the JAX package's fix of the reference's tensor
truthiness test), and the label head runs when they are given and
``label_size > 0``.

Parameter and buffer names are the reference's torch state-dict keys
(``inf_net.input_layer.weight``, ``inf_net.hiddens.l_0.0.weight``,
``inf_net.f_mu_batchnorm.running_mean``, ``inf_net.adapt_bert.weight``,
``label_classification.weight``, ``beta``, ``beta_batchnorm.running_var``,
...). Train/eval follows the module's own ``training`` flag. Randomness
(the reparameterization draw and dropout) comes from the ``generator``
argument; ``noise=`` injects a fixed reparameterization eps instead, as the
JAX network's ``noise=`` does. On a data-parallel rank ``rows`` (a
:class:`~gfedntm_tpu_torch.models.layers.Rows`) names the rows of the whole
batch that the inputs hold: every draw is made at the whole batch's shape
and windowed to them, and :meth:`DecoderNetwork.set_data_group` syncs the
BatchNorms' statistics over the rank's data group.

On a rank of a V-sharded layout (``model_group``, the ranks that split the
vocabulary; :func:`~gfedntm_tpu_torch.parallel.sharded.local_network`
builds the rank's network) the decode runs on the rank's columns: the
softmax over V merges its row maximum and sum over the group
(:func:`~gfedntm_tpu_torch.parallel.collectives.softmax_over_group`), and
theta enters the decode through an identity-forward, sum-backward operator,
so its gradient from the decode is every rank's columns' (the JAX
package's GSPMD program of ``networks.py:275-294`` on sharded beta).

``compute_dtype`` is the JAX networks' ``dtype``: under ``torch.bfloat16``
the encoder's layers (``adapt_bert`` and the label head too), activations,
reparameterization draw, theta and the unfused decodes run in bf16
(``networks.py:58-76``, ``:276-330``) while the parameters and BatchNorm
statistics stay float32, and the BatchNorms compute in float32.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import torch
from torch import nn

from gfedntm_tpu_torch.models.activations import Activation
from gfedntm_tpu_torch.models.initializers import init_linear_, xavier_uniform_2d_
from gfedntm_tpu_torch.models.layers import Linear, MaskedBatchNorm, Rows, draw, dropout
from gfedntm_tpu_torch.parallel.collectives import (
    identity_forward_sum_backward,
    softmax_over_group,
)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as ``jnp.dot`` computes
    it (a theta made float32 by injected float32 noise, times a bf16 beta)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _decode_dot(theta: torch.Tensor, b: torch.Tensor, model_group) -> torch.Tensor:
    """:func:`_dot` of theta and this rank's columns ``b`` of the decode's
    matrix. With a ``model_group`` theta enters through an identity-forward,
    sum-backward operator, so its gradient is every rank's columns' part;
    the product runs on the float32 values and is rounded to the promoted
    dtype once, so a bf16 network's partials of theta's gradient are summed
    in float32 and rounded once, as the unsharded bf16 product rounds its
    float32 accumulation once."""
    if model_group is None:
        return _dot(theta, b)
    dt = torch.promote_types(theta.dtype, b.dtype)
    return (identity_forward_sum_backward(theta.float(), model_group) @ b.float()).to(dt)


class TopicModelOutput(NamedTuple):
    """Forward outputs (the reference forward's tuple plus ``theta``)."""

    prior_mean: torch.Tensor
    prior_variance: torch.Tensor
    posterior_mean: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance: torch.Tensor
    word_dist: torch.Tensor | None
    estimated_labels: torch.Tensor | None
    theta: torch.Tensor


class InferenceNetwork(nn.Module):
    """BoW encoder MLP with affine-free masked-BatchNorm mu / log-var heads.
    ``input_size`` is the input layer's width; the subclasses only choose
    what the input layer reads (:meth:`features`)."""

    def __init__(
        self,
        input_size: int,
        output_size: int,
        hidden_sizes: tuple[int, ...],
        activation: str = "softplus",
        dropout: float = 0.2,
        generator: torch.Generator | None = None,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dropout = dropout
        dt = compute_dtype
        self.input_layer = Linear(input_size, hidden_sizes[0], dt)
        self.activation = Activation(activation)
        self.hiddens = nn.Sequential(OrderedDict(
            (f"l_{i}", nn.Sequential(Linear(h_in, h_out, dt), Activation(activation)))
            for i, (h_in, h_out) in enumerate(zip(hidden_sizes[:-1], hidden_sizes[1:]))
        ))
        self.f_mu = Linear(hidden_sizes[-1], output_size, dt)
        self.f_mu_batchnorm = MaskedBatchNorm(output_size)
        self.f_sigma = Linear(hidden_sizes[-1], output_size, dt)
        self.f_sigma_batchnorm = MaskedBatchNorm(output_size)
        if generator is not None:
            for layer in self.modules():
                if isinstance(layer, nn.Linear):
                    init_linear_(layer, generator)

    def features(self, x_bow, x_ctx, labels) -> torch.Tensor:
        """What the input layer reads: the BoW vector."""
        return x_bow

    def forward(
        self,
        x_bow: torch.Tensor,
        x_ctx: torch.Tensor | None = None,
        labels: torch.Tensor | None = None,
        mask: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        rows: Rows | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.activation(self.input_layer(self.features(x_bow, x_ctx, labels)))
        x = self.hiddens(x)
        x = dropout(x, self.dropout, self.training, generator, rows)
        mu = self.f_mu_batchnorm(self.f_mu(x), mask)
        log_sigma = self.f_sigma_batchnorm(self.f_sigma(x), mask)
        return mu, log_sigma


class ContextualInferenceNetwork(InferenceNetwork):
    """ZeroShotTM encoder: reads only the contextual embedding, with the
    one-hot labels appended when given (width contextual_size + L)."""

    def features(self, x_bow, x_ctx, labels) -> torch.Tensor:
        return x_ctx if labels is None else torch.cat([x_ctx, labels], dim=1)


class CombinedInferenceNetwork(InferenceNetwork):
    """CombinedTM encoder: ``adapt_bert`` projects the contextual embedding
    to V, and the input layer (width 2V + L) reads the BoW vector, that
    projection and, when given, the labels. The concatenation promotes to
    float32, as ``jnp.concatenate`` does; a bf16 input layer rounds it back,
    so ``adapt_bert``'s bf16 output reaches it unchanged."""

    def __init__(
        self,
        vocab_size: int,
        contextual_size: int,
        label_size: int,
        output_size: int,
        hidden_sizes: tuple[int, ...],
        activation: str = "softplus",
        dropout: float = 0.2,
        generator: torch.Generator | None = None,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__(2 * vocab_size + label_size, output_size, hidden_sizes, activation,
                         dropout, generator, compute_dtype)
        self.adapt_bert = Linear(contextual_size, vocab_size, compute_dtype)
        if generator is not None:
            init_linear_(self.adapt_bert, generator)

    def features(self, x_bow, x_ctx, labels) -> torch.Tensor:
        parts = [x_bow, self.adapt_bert(x_ctx)]
        if labels is not None:
            parts.append(labels)
        return torch.cat(parts, dim=1)


class DecoderNetwork(nn.Module):
    """VAE topic model: encoder -> logistic-normal reparam -> theta -> decode.

    ``inference_type`` picks the encoder: ``"bow"`` (AVITM), ``"zeroshot"``
    (ZeroShotTM, over ``contextual_size``-wide embeddings) or
    ``"combined"`` (CombinedTM). ``label_size`` L > 0 adds the label head
    and widens a CTM encoder's input by L. ``model_type="prodLDA"``
    decodes ``softmax(BN(theta @ beta))`` with the unnormalized beta as
    the topic-word matrix; ``"LDA"`` decodes
    ``theta @ softmax(BN(beta))`` (reference ``decoder_network.py:121-132``).
    Priors follow the Laplace approximation of Dirichlet(alpha=1): mean 0,
    variance 1 - 1/K, learnable when ``learn_priors``.

    ``generator`` (a CPU ``torch.Generator``) draws the initial weights;
    move the module to its device afterwards.
    """

    def __init__(
        self,
        input_size: int,
        n_components: int = 10,
        model_type: str = "prodLDA",
        hidden_sizes: tuple[int, ...] = (100, 100),
        activation: str = "softplus",
        dropout: float = 0.2,
        learn_priors: bool = True,
        topic_prior_mean: float = 0.0,
        topic_prior_variance: float | None = None,
        generator: torch.Generator | None = None,
        compute_dtype: torch.dtype = torch.float32,
        inference_type: str = "bow",
        contextual_size: int = 0,
        label_size: int = 0,
    ):
        super().__init__()
        if model_type.lower() not in ("prodlda", "lda"):
            raise ValueError("model_type must be 'prodLDA' or 'LDA'")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        self.model_type = model_type
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        self.inference_type = inference_type
        self.label_size = label_size
        enc = dict(output_size=n_components, hidden_sizes=tuple(hidden_sizes),
                   activation=activation, dropout=dropout, generator=generator,
                   compute_dtype=compute_dtype)
        if inference_type == "bow":
            self.inf_net = InferenceNetwork(input_size, **enc)
        elif inference_type == "zeroshot":
            self.inf_net = ContextualInferenceNetwork(contextual_size + label_size, **enc)
        elif inference_type == "combined":
            self.inf_net = CombinedInferenceNetwork(input_size, contextual_size, label_size,
                                                    **enc)
        else:
            raise ValueError("inference_type must be 'bow', 'zeroshot' or 'combined', "
                             f"got {inference_type!r}")
        k = n_components
        prior_var = 1.0 - 1.0 / k if topic_prior_variance is None else float(topic_prior_variance)
        prior_mean_t = torch.full((k,), float(topic_prior_mean))
        prior_var_t = torch.full((k,), prior_var)
        if learn_priors:
            self.prior_mean = nn.Parameter(prior_mean_t)
            self.prior_variance = nn.Parameter(prior_var_t)
        else:
            # Not in the state dict: the JAX package keeps them as constants.
            self.register_buffer("prior_mean", prior_mean_t, persistent=False)
            self.register_buffer("prior_variance", prior_var_t, persistent=False)
        self.beta = nn.Parameter(torch.empty(k, input_size))
        if generator is None:
            nn.init.xavier_uniform_(self.beta)
        else:
            xavier_uniform_2d_(self.beta, generator)
        self.beta_batchnorm = MaskedBatchNorm(input_size)
        if label_size > 0:
            self.label_classification = Linear(k, label_size, compute_dtype)
            if generator is not None:
                init_linear_(self.label_classification, generator)

    @property
    def is_prodlda(self) -> bool:
        return self.model_type.lower() == "prodlda"

    def set_data_group(self, group) -> None:
        """Sync the training statistics of the encoder's two BatchNorms, and
        of prodLDA's ``beta_batchnorm`` over z = theta beta, over the data
        ``group`` whose ranks split each batch's rows. LDA's
        ``beta_batchnorm`` normalizes the replicated beta and stays local."""
        self.inf_net.f_mu_batchnorm.group = group
        self.inf_net.f_sigma_batchnorm.group = group
        if self.is_prodlda:
            self.beta_batchnorm.group = group

    def _encode(self, x_bow, x_ctx, labels, mask, generator, rows=None):
        mu, log_sigma = self.inf_net(x_bow, x_ctx, labels, mask, generator, rows)
        # Keeps exp(logvar) inside float32 range for degenerate inputs (e.g.
        # all-masked batches, whose BatchNorm rescales by 1/sqrt(eps));
        # |logvar| < 80 is vacuous for any real posterior.
        return mu, torch.clamp(log_sigma, -80.0, 80.0)

    def forward(
        self,
        x_bow: torch.Tensor,
        x_ctx: torch.Tensor | None = None,
        labels: torch.Tensor | None = None,
        *,
        mask: torch.Tensor | None = None,
        noise: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        rows: Rows | None = None,
        model_group=None,
    ) -> TopicModelOutput:
        """The whole forward; with a ``model_group`` (a V-sharded rank) the
        word distribution is this rank's columns of it. The KL's inputs
        (the posterior) stay outside the sum-backward operator: every rank
        computes the same KL."""
        out = self.encode_theta(x_bow, x_ctx, labels, mask=mask, noise=noise,
                                generator=generator, rows=rows)
        beta = self.beta.to(self.compute_dtype)
        if self.is_prodlda:
            z = _decode_dot(out.theta, beta, model_group)
            word_dist = softmax_over_group(self.beta_batchnorm(z, mask), model_group)
        else:
            # BN over beta's topic axis; no sample mask applies.
            beta_sm = softmax_over_group(self.beta_batchnorm(beta), model_group)
            word_dist = _decode_dot(out.theta, beta_sm, model_group)
        return out._replace(word_dist=word_dist)

    def encode_theta(
        self,
        x_bow: torch.Tensor,
        x_ctx: torch.Tensor | None = None,
        labels: torch.Tensor | None = None,
        *,
        mask: torch.Tensor | None = None,
        noise: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        rows: Rows | None = None,
    ) -> TopicModelOutput:
        """Encoder + reparameterization + theta-dropout without the decode,
        for callers that fuse the decode + loss into the kernels; with
        labels and a label head, the head's logits on theta. The
        ``beta_batchnorm`` running stats are left untouched (the fused
        caller updates them from the kernel's batch statistics). ``noise``
        holds the inputs' rows."""
        mu, log_sigma = self._encode(x_bow, x_ctx, labels, mask, generator, rows)
        std = torch.exp(0.5 * log_sigma)
        eps = noise if noise is not None else draw(
            torch.randn, std.shape, rows, generator=generator, device=std.device,
            dtype=std.dtype,
        )
        theta = torch.softmax(mu + eps * std, dim=1)
        theta = dropout(theta, self.dropout, self.training, generator, rows)
        estimated_labels = None
        if labels is not None and self.label_size > 0:
            estimated_labels = self.label_classification(theta)
        return TopicModelOutput(
            prior_mean=self.prior_mean,
            prior_variance=self.prior_variance,
            posterior_mean=mu,
            posterior_variance=torch.exp(log_sigma),
            posterior_log_variance=log_sigma,
            word_dist=None,
            estimated_labels=estimated_labels,
            theta=theta,
        )

    def get_theta(
        self,
        x_bow: torch.Tensor,
        x_ctx: torch.Tensor | None = None,
        labels: torch.Tensor | None = None,
        *,
        noise: torch.Tensor | float | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Sample theta with running BatchNorm stats and no dropout
        (reference ``decoder_network.py:137-147``). ``noise=0.0`` gives the
        deterministic posterior-mean theta ``softmax(mu)``."""
        was_training = self.training
        self.eval()
        try:
            mu, log_sigma = self._encode(x_bow, x_ctx, labels, None, generator)
        finally:
            self.train(was_training)
        std = torch.exp(0.5 * log_sigma)
        eps = noise if noise is not None else torch.randn(
            std.shape, generator=generator, device=std.device, dtype=std.dtype
        )
        return torch.softmax(mu + eps * std, dim=1)
