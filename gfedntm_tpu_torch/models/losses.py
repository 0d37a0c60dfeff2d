"""ELBO losses as plain functions on tensors.

Counterpart of ``gfedntm_tpu/models/losses.py`` (``gaussian_kl``,
``reconstruction_loss``, ``avitm_loss``, ``cross_entropy_with_logits``,
``ctm_loss``): a closed-form Gaussian KL between the logistic-normal
posterior and the (possibly learnable) prior, plus the multinomial
reconstruction term ``-sum(x * log(word_dist + 1e-10))`` (reference
``avitm.py:203-229``); CTM weighs the KL by ``beta_weight`` and adds the
label head's cross-entropy, a mean over the batch's real rows (reference
``ctm.py:286-296``). Per-sample values are [batch]; ``avitm_loss`` and
``ctm_loss`` sum over the batch after the optional ``sample_mask``
(:func:`elbo_sum`, which the training steps call with their own
reconstruction term).
A bf16 posterior (``compute_dtype="bfloat16"``) against the float32 priors
gives a float32 KL, as in the JAX package.

On a data-parallel rank (``data_group``: the ranks that split the batch's
rows) the cross-entropy's mean divides by the real rows of the whole batch,
so the ranks' terms sum to the whole batch's mean.
"""

from __future__ import annotations

import torch

from gfedntm_tpu_torch.models.layers import batch_count

EPS = 1e-10  # reference floor inside log, avitm.py:225


def gaussian_kl(
    prior_mean: torch.Tensor,
    prior_variance: torch.Tensor,
    posterior_mean: torch.Tensor,
    posterior_variance: torch.Tensor,
    posterior_log_variance: torch.Tensor,
) -> torch.Tensor:
    """Per-sample KL(q || p) for diagonal Gaussians (avitm.py:203-220)."""
    n_components = posterior_mean.shape[-1]
    var_division = torch.sum(posterior_variance / prior_variance, dim=-1)
    diff = prior_mean - posterior_mean
    diff_term = torch.sum((diff * diff) / prior_variance, dim=-1)
    # A 0-dim tensor does not take part in torch's type promotion, so the
    # posterior sum is cast explicitly: a bf16 posterior against float32
    # priors computes in float32, as jnp's promotion does.
    post_log_det = torch.sum(posterior_log_variance, dim=-1)
    logvar_det_division = torch.sum(torch.log(prior_variance)) - post_log_det.to(
        torch.promote_types(post_log_det.dtype, prior_variance.dtype)
    )
    return 0.5 * (var_division + diff_term - n_components + logvar_det_division)


def reconstruction_loss(inputs: torch.Tensor, word_dists: torch.Tensor) -> torch.Tensor:
    """Per-sample multinomial NLL: ``-sum(x * log(p + 1e-10))``."""
    return -torch.sum(inputs * torch.log(word_dists + EPS), dim=-1)


def avitm_loss(
    inputs: torch.Tensor,
    word_dists: torch.Tensor,
    prior_mean: torch.Tensor,
    prior_variance: torch.Tensor,
    posterior_mean: torch.Tensor,
    posterior_variance: torch.Tensor,
    posterior_log_variance: torch.Tensor,
    sample_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Batch-summed AVITM ELBO loss; ``sample_mask`` zeroes padding rows so
    the sum equals the reference's sum over the (shorter) real batch."""
    kl = gaussian_kl(
        prior_mean, prior_variance, posterior_mean, posterior_variance,
        posterior_log_variance,
    )
    return elbo_sum(kl, reconstruction_loss(inputs, word_dists), sample_mask=sample_mask)


def cross_entropy_with_logits(
    logits: torch.Tensor,
    target_idx: torch.Tensor,
    sample_mask: torch.Tensor | None = None,
    data_group=None,
) -> torch.Tensor:
    """torch ``nn.CrossEntropyLoss()`` (mean reduction) over integer targets.
    With ``sample_mask`` the mean runs over the real rows only, so padding
    rows do not dilute it; their count is the whole batch's over
    ``data_group``."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, target_idx[:, None])[:, 0]
    if sample_mask is None:
        return torch.mean(nll)
    msk = sample_mask.to(nll.dtype)
    return torch.sum(nll * msk) / batch_count(sample_mask, data_group)


def ctm_loss(
    inputs: torch.Tensor,
    word_dists: torch.Tensor,
    prior_mean: torch.Tensor,
    prior_variance: torch.Tensor,
    posterior_mean: torch.Tensor,
    posterior_variance: torch.Tensor,
    posterior_log_variance: torch.Tensor,
    beta_weight: float = 1.0,
    estimated_labels: torch.Tensor | None = None,
    labels_onehot: torch.Tensor | None = None,
    sample_mask: torch.Tensor | None = None,
    data_group=None,
) -> torch.Tensor:
    """CTM loss: ``(beta_weight * KL + RL).sum()`` plus, with labels, the
    cross-entropy of the label head against the argmax of the one-hot
    labels (the reference's latent ``NameError`` on that branch,
    ``federated_ctm.py:104``, is read as its intended semantics, as the
    JAX package does)."""
    kl = gaussian_kl(
        prior_mean, prior_variance, posterior_mean, posterior_variance,
        posterior_log_variance,
    )
    return elbo_sum(kl, reconstruction_loss(inputs, word_dists), beta_weight, sample_mask,
                    estimated_labels, labels_onehot, data_group)


def elbo_sum(
    kl: torch.Tensor,
    rl: torch.Tensor,
    beta_weight: float = 1.0,
    sample_mask: torch.Tensor | None = None,
    estimated_labels: torch.Tensor | None = None,
    labels_onehot: torch.Tensor | None = None,
    data_group=None,
) -> torch.Tensor:
    """``sum(beta_weight * kl + rl)`` over the rows ``sample_mask`` keeps,
    plus, with label logits and one-hot labels, the label cross-entropy
    (:func:`cross_entropy_with_logits`); ``kl`` and ``rl`` are per-sample."""
    loss = beta_weight * kl + rl
    if sample_mask is not None:
        loss = loss * sample_mask.to(loss.dtype)
    total = torch.sum(loss)
    if estimated_labels is not None and labels_onehot is not None:
        total = total + cross_entropy_with_logits(
            estimated_labels, torch.argmax(labels_onehot, dim=1), sample_mask, data_group
        )
    return total
