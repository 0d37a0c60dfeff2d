"""Network federation for remote clients (gRPC), in the JAX package's
protocol byte for byte.

Counterpart of ``gfedntm_tpu/federation/``: the reference's deployment
shape, one process per organization, with a :class:`FederatedServer`
polling every :class:`Client` per minibatch (sync pacing), or a two-tier
federation whose root polls :class:`RelayNode` shards. Port nodes
federate with JAX nodes in both directions and with each other. Exports
what the JAX package's ``federation/__init__.py`` exports of the ported
modules.
"""

from gfedntm_tpu_torch.federation import codec as codec
from gfedntm_tpu_torch.federation import rpc as rpc
from gfedntm_tpu_torch.federation.client import Client, FederatedClientServicer
from gfedntm_tpu_torch.federation.pacing import PacingSpec, parse_pacing
from gfedntm_tpu_torch.federation.registry import ClientRecord, Federation
from gfedntm_tpu_torch.federation.relay import RelayNode
from gfedntm_tpu_torch.federation.resilience import (
    FaultInjector,
    FaultSpec,
    RetryPolicy,
)
from gfedntm_tpu_torch.federation.server import FederatedServer, build_template_model
