"""Federation: tag-addressed object transfer between parties (port of
flashe_tpu/fed).

Control-plane and key-exchange objects and the model payloads move over a
pluggable transport: the in-memory broker for simulation and tests, where
CUDA tensors pass by reference, and TCP across processes or hosts, where
everything is pickled from the host.  The port's TCP broker is the JAX
package's Python broker; it needs no build, so it is imported here as the
JAX package imports its own.
"""

from flashe_tpu_torch.fed.consts import ARBITER, GUEST, HOST
from flashe_tpu_torch.fed.transport import Federation, Party
from flashe_tpu_torch.fed.inmem import InMemBroker, InMemFederation
from flashe_tpu_torch.fed.tcp import FedBroker, TcpFederation

__all__ = [
    "ARBITER", "GUEST", "HOST",
    "Federation", "Party", "InMemBroker", "InMemFederation",
    "FedBroker", "TcpFederation",
]
