"""ELBO losses as plain functions on tensors.

Counterpart of ``gfedntm_tpu/models/losses.py`` (``gaussian_kl``,
``reconstruction_loss``, ``avitm_loss``): a closed-form Gaussian KL between
the logistic-normal posterior and the (possibly learnable) prior, plus the
multinomial reconstruction term ``-sum(x * log(word_dist + 1e-10))``
(reference ``avitm.py:203-229``). Per-sample values are [batch];
``avitm_loss`` sums over the batch after the optional ``sample_mask``.
A bf16 posterior (``compute_dtype="bfloat16"``) against the float32 priors
gives a float32 KL, as in the JAX package.
"""

from __future__ import annotations

import torch

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
    loss = kl + reconstruction_loss(inputs, word_dists)
    if sample_mask is not None:
        loss = loss * sample_mask.to(loss.dtype)
    return torch.sum(loss)
