"""Gateway admission control: bounded in-flight, shed-before-collapse.

Under overload a broker that keeps accepting commands converts every new
request into queue time: clients see p99 latency grow without bound until
their own deadlines fire, at which point they retry and make it worse.
The reference behavior for a full broker is backpressure at the request
boundary (the client API rejects with RESOURCE_EXHAUSTED and the client
retries with backoff) — never queue-until-timeout.

:class:`AdmissionController` enforces two watermarks at the client-API
edge, BEFORE a command touches the broker actor:

- **per-connection in-flight bound** — one client connection may have at
  most ``max_inflight_per_connection`` commands awaiting responses; the
  excess is rejected retryably. This bounds what a single misbehaving
  client can queue regardless of aggregate load.
- **queue-depth watermark** — when the broker-wide backlog (committed
  records awaiting the drain + pending responses) crosses
  ``queue_depth_high``, NEW commands are shed until it recedes. The probe
  is supplied by the broker (the wave scheduler's ``backlog()`` plus its
  pending-response map).

Rejections are counted (``gateway_commands_shed``, labeled by reason) and
carry a ``retry_ms`` hint; ``gateway/cluster_client.py`` treats the
rejection as retryable with backoff. Checks run on the transport IO
thread and are lock-cheap (one dict op per command).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from zeebe_tpu_torch.runtime.metrics import GLOBAL_REGISTRY
from zeebe_tpu_torch.tracing.recorder import RateLimitedEvent

# rejection reasons (the wire carries them for observability; the client
# treats any RESOURCE_EXHAUSTED identically — back off and retry)
REASON_CONNECTION_INFLIGHT = "CONNECTION_INFLIGHT"
REASON_QUEUE_DEPTH = "QUEUE_DEPTH"


class AdmissionConfig:
    """Knobs (see ``runtime/config.AdmissionCfg`` for the TOML surface)."""

    __slots__ = (
        "enabled", "max_inflight_per_connection", "queue_depth_high",
        "retry_after_ms",
    )

    def __init__(
        self,
        enabled: bool = True,
        max_inflight_per_connection: int = 1024,
        queue_depth_high: int = 8192,
        retry_after_ms: int = 50,
    ):
        self.enabled = enabled
        self.max_inflight_per_connection = max(1, max_inflight_per_connection)
        self.queue_depth_high = max(1, queue_depth_high)
        self.retry_after_ms = max(1, retry_after_ms)


class AdmissionController:
    """Per-broker admission state. Thread-safe: ``try_admit`` runs on
    transport IO threads, ``release`` on whatever thread completes the
    response future."""

    def __init__(
        self,
        config: Optional[AdmissionConfig] = None,
        queue_depth_probe: Optional[Callable[[], int]] = None,
    ):
        self.config = config or AdmissionConfig()
        self._queue_depth_probe = queue_depth_probe
        self._lock = threading.Lock()
        self._inflight: Dict[int, int] = {}  # conn key → commands awaiting
        g = GLOBAL_REGISTRY
        self._shed_conn = g.counter(
            "gateway_commands_shed",
            "Commands rejected retryably at the admission boundary",
            reason=REASON_CONNECTION_INFLIGHT,
        )
        self._shed_queue = g.counter(
            "gateway_commands_shed",
            "Commands rejected retryably at the admission boundary",
            reason=REASON_QUEUE_DEPTH,
        )
        self._inflight_gauge = g.gauge(
            "gateway_inflight_commands",
            "Client commands admitted and awaiting responses (all "
            "connections)",
        )
        self._depth_gauge = g.gauge(
            "gateway_queue_depth",
            "Broker backlog observed by the last admission check "
            "(committed records awaiting the drain + pending responses)",
        )
        self._probe_failures = g.counter(
            "gateway_depth_probe_failures",
            "Queue-depth probe calls that raised (admission fails open "
            "with depth 0)",
        )
        # sheds burst at per-command rate under exactly the overload a
        # flight dump wants to explain — rate-limit the ring entries so
        # they cannot evict the control-plane history (counters above
        # stay exact)
        self._shed_event = RateLimitedEvent("admission", "command shed")

    def set_queue_depth_probe(self, probe: Callable[[], int]) -> None:
        self._queue_depth_probe = probe

    # -- the admission decision --------------------------------------------
    def try_admit(self, conn_key: int) -> Optional[str]:
        """Admit one command from ``conn_key``. Returns None when admitted
        (caller MUST pair with ``release``), else the rejection reason."""
        cfg = self.config
        if not cfg.enabled:
            return None
        probe = self._queue_depth_probe
        if probe is not None:
            try:
                depth = int(probe())
            except Exception:  # noqa: BLE001 - a probe bug must not shed
                self._probe_failures.inc()
                depth = 0
            self._depth_gauge.set(depth)
            if depth >= cfg.queue_depth_high:
                self._shed_queue.inc()
                self._shed_event.record(
                    reason=REASON_QUEUE_DEPTH, depth=depth,
                )
                return REASON_QUEUE_DEPTH
        with self._lock:
            inflight = self._inflight.get(conn_key, 0)
            if inflight >= cfg.max_inflight_per_connection:
                self._shed_conn.inc()
                self._shed_event.record(
                    reason=REASON_CONNECTION_INFLIGHT, conn=conn_key,
                    inflight=inflight,
                )
                return REASON_CONNECTION_INFLIGHT
            self._inflight[conn_key] = inflight + 1
        self._inflight_gauge.inc()
        return None

    def release(self, conn_key: int) -> None:
        """One admitted command finished (response sent or failed)."""
        with self._lock:
            inflight = self._inflight.get(conn_key)
            if inflight is None:
                return
            if inflight <= 1:
                self._inflight.pop(conn_key, None)
            else:
                self._inflight[conn_key] = inflight - 1
        self._inflight_gauge.inc(-1)

    def forget_connection(self, conn_key: int) -> None:
        """The connection closed: drop its in-flight accounting (its
        pending responses can no longer be delivered anyway)."""
        with self._lock:
            dropped = self._inflight.pop(conn_key, 0)
        if dropped:
            self._inflight_gauge.inc(-dropped)

    def inflight(self, conn_key: Optional[int] = None) -> int:
        with self._lock:
            if conn_key is not None:
                return self._inflight.get(conn_key, 0)
            return sum(self._inflight.values())

    def rejection_body(self, reason: str) -> dict:
        """The wire response for a shed command (retryable by contract)."""
        return {
            "t": "error",
            "code": "RESOURCE_EXHAUSTED",
            "reason": reason,
            "retry_ms": self.config.retry_after_ms,
        }
