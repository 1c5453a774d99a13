"""Test utilities shipped with the framework (reference parity:
``protocol-test-util`` — the stub broker, record asserts, controlled
clocks are product surface, not private test code)."""

from zeebe_tpu_torch.testing.stub_broker import StubBroker  # noqa: F401
from zeebe_tpu_torch.testing.chaos import (  # noqa: F401
    ChaosHarness,
    DiskFaults,
    FaultPlane,
    oracle_state_bytes,
    replay_oracle,
)
