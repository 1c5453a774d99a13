from zeebe_tpu_torch.transport.transport import (
    ClientTransport,
    RemoteAddress,
    ServerTransport,
    TransportError,
)

__all__ = ["ClientTransport", "ServerTransport", "RemoteAddress", "TransportError"]
