"""Scriptable stub broker speaking the native client protocol.

Reference parity: ``protocol-test-util/.../brokerapi/StubBrokerRule.java``
— a fake broker for CLIENT-side unit tests: every request is recorded,
responses are scripted per request type, and failure modes (timeouts,
rejections, disconnects, redirects) are injected deterministically. Works
for any native-protocol client: the Python ``ClusterClient`` and the C++
``clients/cpp/zbclient`` speak to it unchanged.

    stub = StubBroker()
    stub.reject_next("command", reason="boom")     # one scripted rejection
    stub.drop_next("command")                      # swallow → client timeout
    stub.on("command", fn)                         # custom responder
    ...
    stub.requests  ->  [(type, decoded msg), ...]  # everything recorded
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from zeebe_tpu_torch.protocol import codec, msgpack
from zeebe_tpu_torch.protocol.enums import RecordType, RejectionType, ValueType
from zeebe_tpu_torch.protocol.records import Record
from zeebe_tpu_torch.transport import ServerTransport


class StubBroker:
    """A fake single-partition broker with scripted behavior."""

    def __init__(self, host: str = "127.0.0.1", partition_id: int = 0):
        self.partition_id = partition_id
        self.requests: List[Tuple[str, dict]] = []
        self._responders: Dict[str, Callable[[dict], Optional[bytes]]] = {}
        self._scripted: Dict[str, List[Callable[[dict], Optional[bytes]]]] = {}
        self._delay_ms: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._keys = itertools.count(100)
        self._conns: List = []
        self._conn_ids: set = set()
        # subscriber key → the connection that subscribed (pushes go to
        # the subscriber's own connection, like SubscribedRecordWriter)
        self._subscriber_conns: Dict[int, object] = {}
        self.server = ServerTransport(
            host=host, request_handler=self._on_request
        )

    # -- scripting API -----------------------------------------------------
    def on(self, rtype: str, responder: Callable[[dict], Optional[bytes]]) -> None:
        """Replace the default responder for ``rtype``. Return None to
        swallow the request (client times out)."""
        self._responders[rtype] = responder

    def script_next(self, rtype: str, responder: Callable[[dict], Optional[bytes]]) -> None:
        """One-shot scripted response consumed before default handling."""
        with self._lock:
            self._scripted.setdefault(rtype, []).append(responder)

    def drop_next(self, rtype: str) -> None:
        """Swallow the next ``rtype`` request — the client sees a timeout
        (reference StubBrokerRule's doNotRespond)."""
        self.script_next(rtype, lambda msg: None)

    def reject_next(
        self,
        rtype: str = "command",
        reason: str = "scripted rejection",
        rejection_type: RejectionType = RejectionType.BAD_VALUE,
    ) -> None:
        """The next command is answered with a COMMAND_REJECTION."""

        def responder(msg):
            record, _ = codec.decode_record(bytes(msg["frame"]))
            record.metadata.record_type = RecordType.COMMAND_REJECTION
            record.metadata.rejection_type = rejection_type
            record.metadata.rejection_reason = reason
            return msgpack.pack(
                {"t": "command-rsp", "frame": codec.encode_record(record)}
            )

        self.script_next(rtype, responder)

    def redirect_next(self, rtype: str = "command") -> None:
        """The next command is answered NOT_LEADER (leader-change window)."""
        self.script_next(
            rtype,
            lambda msg: msgpack.pack({"t": "error", "code": "NOT_LEADER"}),
        )

    def delay(self, rtype: str, delay_ms: int) -> None:
        """Latency injection for every ``rtype`` request."""
        self._delay_ms[rtype] = delay_ms

    def requests_of(self, rtype: str) -> List[dict]:
        with self._lock:
            return [m for t, m in self.requests if t == rtype]

    # -- push (job/topic subscription) --------------------------------------
    def push_job(
        self,
        subscriber_key: int,
        record: Record,
        partition: Optional[int] = None,
    ) -> None:
        """Push an ACTIVATED job record to connected subscribers (the
        worker-side push path without a real engine)."""
        payload = msgpack.pack(
            {
                "t": "pushed-record",
                "partition": self.partition_id if partition is None else partition,
                "subscriber_key": subscriber_key,
                "frame": codec.encode_record(record),
            }
        )
        conn = self._subscriber_conns.get(subscriber_key)
        targets = [conn] if conn is not None else list(self._conns)
        for target in targets:
            try:
                target.push(payload)
            except Exception:  # noqa: BLE001 - dead test connection
                pass

    # -- wiring -------------------------------------------------------------
    @property
    def address(self):
        return self.server.address

    def _on_request(self, payload: bytes, conn):
        try:
            msg = msgpack.unpack(payload)
        except Exception:  # noqa: BLE001
            return None
        rtype = str(msg.get("t"))
        with self._lock:
            self.requests.append((rtype, msg))
            queue = self._scripted.get(rtype)
            scripted = queue.pop(0) if queue else None
        if conn is not None:
            # ServerTransport hands a FRESH handle per request; dedupe by
            # the underlying connection so broadcast pushes fire once
            sock_id = id(getattr(conn, "_conn", conn))
            if sock_id not in self._conn_ids:
                self._conn_ids.add(sock_id)
                self._conns.append(conn)
        if (
            conn is not None
            and rtype == "job-subscription"
            and msg.get("action") == "add"
            and "subscriber_key" in msg
        ):
            self._subscriber_conns[int(msg["subscriber_key"])] = conn
        def respond():
            if scripted is not None:
                return scripted(msg)
            responder = self._responders.get(rtype)
            if responder is not None:
                return responder(msg)
            return self._default(rtype, msg)

        delay = self._delay_ms.get(rtype)
        if delay:
            # latency injection OFF the transport IO thread: other request
            # types and queued pushes must keep flowing during the delay
            from zeebe_tpu_torch.runtime.actors import ActorFuture

            future = ActorFuture()

            def later():
                time.sleep(delay / 1000.0)
                future.complete(respond())

            threading.Thread(target=later, daemon=True).start()
            return future
        return respond()

    # -- default behaviors (the happy-path canned broker) -------------------
    def _default(self, rtype: str, msg: dict) -> Optional[bytes]:
        if rtype == "topology":
            return msgpack.pack(
                {
                    "t": "topology-rsp",
                    "leaders": {
                        str(self.partition_id): {
                            "node": "stub-0",
                            "addr": [self.address.host, self.address.port],
                            "term": 1,
                        }
                    },
                }
            )
        if rtype == "command":
            # echo the command back as the accepted event (intent + 1 — the
            # usual CREATE→CREATED / COMPLETE→COMPLETED pairing)
            record, _ = codec.decode_record(bytes(msg["frame"]))
            record.metadata.record_type = RecordType.EVENT
            record.metadata.intent = int(record.metadata.intent) + 1
            if record.key < 0:
                record.key = next(self._keys)
            if int(record.metadata.value_type) == int(ValueType.WORKFLOW_INSTANCE):
                record.value.workflow_instance_key = record.key
            return msgpack.pack(
                {"t": "command-rsp", "frame": codec.encode_record(record)}
            )
        if rtype == "job-subscription":
            return msgpack.pack({"t": "ok"})
        if rtype == "topic-subscription":
            return msgpack.pack({"t": "ok"})
        if rtype in ("list-workflows",):
            return msgpack.pack({"t": "ok", "workflows": []})
        if rtype == "get-workflow":
            return msgpack.pack({"t": "error", "code": "NOT_FOUND"})
        return msgpack.pack({"t": "error", "code": "UNSUPPORTED"})

    def close(self) -> None:
        self.server.close()
