"""Generated protobuf stubs for the published gateway contract
(gateway-protocol/gateway.proto). Regenerate with the command in the
proto's header comment."""

from zeebe_tpu_torch.gateway.proto import gateway_pb2  # noqa: F401
