"""Privacy plane: DP mechanisms and the (ε, δ) accountant.

A copy of ``gfedntm_tpu/privacy/__init__.py``:

- server-side FedLD noise (:class:`~.mechanisms.ServerNoiser`), added to
  the aggregate after the (possibly robust) mean stage;
- client-side DP-SGD (:class:`~.mechanisms.ClientSanitizer`): each client
  clips its outgoing update to an L2 ball and adds seeded Gaussian noise
  before the update leaves it;
- the RDP ledger (:class:`~.accountant.PrivacyAccountant`), one step per
  aggregated round, carried in the server's journal and checkpoints.

``dp="off"`` constructs none of these objects.
"""

from gfedntm_tpu_torch.privacy.accountant import (
    ALPHAS,
    PrivacyAccountant,
    eps_from_rdp,
    gaussian_rdp,
    subsampled_gaussian_rdp,
)
from gfedntm_tpu_torch.privacy.mechanisms import (
    ClientSanitizer,
    DPSpec,
    ServerNoiser,
    host_noise_vector,
    parse_dp,
)

__all__ = [
    "ALPHAS",
    "PrivacyAccountant",
    "eps_from_rdp",
    "gaussian_rdp",
    "subsampled_gaussian_rdp",
    "DPSpec",
    "parse_dp",
    "ServerNoiser",
    "ClientSanitizer",
    "host_noise_vector",
]
