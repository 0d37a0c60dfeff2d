"""Wire schema: byte-identical copies of ``gfedntm_tpu/federation/protos/``
(``federated.proto`` and its generated ``federated_pb2.py``).

The generated module registers ``federated.proto`` in protobuf's default
descriptor pool. A copy that is byte for byte the JAX package's imports
beside it in one process and resolves to the same descriptors and message
classes; a copy that differed by one field would conflict. So the schema is
edited in the JAX package and copied here, never edited here alone. The
proto package ``gfedntm`` and the service names ``gfedntm.Federation`` and
``gfedntm.FederationClient`` are what a peer of either package finds its
methods by.
"""

from gfedntm_tpu_torch.federation.protos import federated_pb2 as federated_pb2
