"""Which state-dict entries federate.

Counterpart of ``gfedntm_tpu/models/params.py`` and the share lists of
``gfedntm_tpu/config.py:25-27``. The reference names the shared tensors by
torch state-dict key (``config/dft_params.cf:50``); the port's modules use
those very keys (``inf_net.hiddens.l_0.0.weight``, ``beta``,
``beta_batchnorm.running_var``, ...), so a ``grads_to_share`` list selects
state-dict entries directly. Keys the model lacks are skipped, as in the
reference (its default list names CombinedTM's ``inf_net.adapt_bert.*``).
"""

from __future__ import annotations

from typing import Iterable

# The reference's operative default: federate the full model state
# (config/dft_params.cf:50). SHARE_ALL selects every param and buffer.
SHARE_ALL = ("__all__",)
# The reference's code-level default (server.py:71, client.py:205).
SHARE_MINIMAL = ("prior_mean", "prior_variance", "beta")


def build_share_mask(
    state_keys: Iterable[str], grads_to_share: Iterable[str]
) -> dict[str, bool]:
    """``{state-dict key: shared?}`` over ``state_keys`` (e.g.
    ``module.state_dict().keys()``)."""
    grads_to_share = tuple(grads_to_share)
    share_all = grads_to_share == SHARE_ALL
    wanted = set(grads_to_share)
    return {key: share_all or key in wanted for key in state_keys}
