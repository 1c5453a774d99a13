"""Async TCP transport: request/response + single-message mode.

Reference parity: ``transport/`` — custom java.nio client/server transport
with correlation-id request/response (``ClientOutput.sendRequest`` with
retries + timeout), fire-and-forget messages, length-prefixed framing
(``TransportHeaderDescriptor`` / ``RequestResponseHeaderDescriptor``),
selector-driven read/write pollers (``transport/.../impl/selector/``) and
actor-integrated dispatch. The reference runs 4 logical networks per broker
(client/management/replication/subscription) — here each is simply its own
``ServerTransport`` on its own port.

Re-design: one IO thread per transport drives a ``selectors`` event loop
(the reference's Sender/Receiver actor pair); handlers run on the caller's
actor or a handler thread, responses are correlated back to pending
``ActorFuture``s.

Frame layout (little-endian):
    u32 frame_length (excluding this field)
    u8  frame_type   (1=REQUEST, 2=RESPONSE, 3=MESSAGE)
    u64 correlation_id (0 for MESSAGE)
    ... payload ...
"""

from __future__ import annotations

import dataclasses
import itertools
import selectors
import socket
import struct
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

from zeebe_tpu_torch._events import count_event as _count_event
from zeebe_tpu_torch.runtime.actors import ActorFuture

_HDR = struct.Struct("<IBQ")
REQUEST = 1
RESPONSE = 2
MESSAGE = 3


class TransportError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class RemoteAddress:
    host: str
    port: int

    def __str__(self):
        return f"{self.host}:{self.port}"


def _encode(frame_type: int, correlation_id: int, payload: bytes) -> bytes:
    return _HDR.pack(len(payload) + 9, frame_type, correlation_id) + payload


def _deliver(loop: "_IoLoop", conn: "_Conn", peer, data: bytes, hook) -> None:
    """Send ``data`` on ``conn``, consulting the optional fault-injection
    hook first (``zeebe_tpu.testing.chaos.FaultPlane`` installs one).

    ``hook(peer, data)`` returns a list of ``(delay_seconds, payload)``
    deliveries — empty list drops the frame, a >0 delay defers it (reorder
    and duplication fall out of multiple entries), ``None`` means deliver
    normally. ``peer`` is the dialed RemoteAddress on the client side and
    None on the server side (responses ride the requester's connection)."""
    if hook is None:
        loop.send(conn, data)
        return
    deliveries = hook(peer, data)
    if deliveries is None:
        loop.send(conn, data)
        return
    for delay_s, chunk in deliveries:
        if delay_s <= 0:
            loop.send(conn, chunk)
        else:
            timer = threading.Timer(
                delay_s,
                lambda c=conn, d=chunk: loop.send(c, d) if c.open else None,
            )
            timer.daemon = True
            timer.start()


class _Conn:
    """One socket's buffered state (either side)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.rbuf = bytearray()
        self.wbuf = bytearray()
        self.lock = threading.Lock()
        self.open = True
        self.close_listeners: list = []
        # write-interest request already posted/active: back-to-back sends
        # on a busy connection skip the per-message post+wake round trip
        # (a syscall per message on the serving firehose otherwise)
        self.want_w_pending = False

    MAX_FRAME = 64 * 1024 * 1024

    def frames(self):
        """Yield complete (type, correlation_id, payload) frames. A
        malformed length poisons the connection (raises ValueError — the
        caller closes it; a bad peer must not kill the IO loop)."""
        while True:
            if len(self.rbuf) < 4:
                return
            (length,) = struct.unpack_from("<I", self.rbuf, 0)
            if length < 9 or length > self.MAX_FRAME:
                raise ValueError(f"malformed frame length {length}")
            if len(self.rbuf) < 4 + length:
                return
            _, ftype, cid = _HDR.unpack_from(self.rbuf, 0)
            payload = bytes(self.rbuf[13 : 4 + length])
            del self.rbuf[: 4 + length]
            yield ftype, cid, payload


class _IoLoop:
    """Selector loop shared by server and client transports.

    Threading contract: ``selectors`` objects are NOT thread-safe, and the
    send paths run on arbitrary caller threads. Every selector mutation
    (register / modify / unregister) therefore executes ON the IO thread —
    other threads post a command and wake the loop. An earlier revision
    called ``selector.modify`` directly from caller threads with a blanket
    ``except KeyError: pass``; two racing modifies could silently leave a
    socket's write interest disabled with a non-empty write buffer, wedging
    the connection until every in-flight request timed out (the
    ``test_concurrent_callers`` 4-way stall). Reference analogue: all
    channel interest changes run on the Sender/Receiver actors
    (``transport/.../impl/selector/``)."""

    def __init__(self, name: str):
        self.selector = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self.selector.register(self._wake_r, selectors.EVENT_READ, ("wake", None))
        self._running = True
        self._cmds: "deque" = deque()
        # wake coalescing: one pending wake byte at a time — a burst of
        # posts pays ONE socketpair syscall, not one per message (the
        # flag clears on the IO thread before the command drain, so a
        # post racing the clear just sends a fresh wake)
        self._wake_pending = False
        self.thread = threading.Thread(target=self._run, name=name, daemon=True)

    def start(self):
        self.thread.start()
        return self

    def wake(self):
        if self._wake_pending:
            return
        self._wake_pending = True
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass

    def post(self, fn) -> None:
        """Run ``fn`` on the IO thread (immediately when already on it)."""
        if threading.current_thread() is self.thread:
            fn()
            return
        self._cmds.append(fn)
        self.wake()

    def stop(self):
        if not self._running:
            return  # idempotent: close() may be called by owner and teardown
        self._running = False
        self.wake()
        self.thread.join(timeout=5)
        for key in list((self.selector.get_map() or {}).values()):
            try:
                key.fileobj.close()
            except OSError:
                pass
        self.selector.close()

    def _drain_cmds(self):
        while True:
            try:
                fn = self._cmds.popleft()
            except IndexError:
                return
            try:
                fn()
            except Exception:  # noqa: BLE001
                import traceback

                traceback.print_exc()

    def _run(self):
        while self._running:
            self._drain_cmds()
            events = self.selector.select(timeout=0.05)
            self._drain_cmds()
            for key, mask in events:
                kind, ctx = key.data
                try:
                    if kind == "wake":
                        try:
                            self._wake_r.recv(4096)
                        except OSError:
                            pass
                        # clear AFTER the recv: a post between a clear and
                        # the recv would otherwise have its byte drained
                        # with the flag left True — later posts would then
                        # skip the wake and wait out a full select. A post
                        # racing this clear either re-arms (flag seen
                        # False → fresh byte) or was already appended and
                        # rides the loop-top drain before the next select.
                        self._wake_pending = False
                    elif kind == "accept":
                        ctx()  # server accept callback
                    elif kind == "conn":
                        ctx(key.fileobj, mask)
                except Exception:  # noqa: BLE001 - one bad peer must not
                    # take down the loop; drop the offending connection
                    import traceback

                    traceback.print_exc()
                    if kind == "conn":
                        try:
                            self.selector.unregister(key.fileobj)
                        except (KeyError, ValueError):
                            pass
                        try:
                            key.fileobj.close()
                        except OSError:
                            pass
        # loop exit: sockets closed in stop()

    def register_conn(self, conn: _Conn, handler):
        conn.sock.setblocking(False)

        def _register():
            if not conn.open:
                return
            # sync write interest from the buffer: a caller thread may have
            # queued bytes (and a want_write that no-op'd) before this
            # registration command ran
            events = selectors.EVENT_READ | (
                selectors.EVENT_WRITE if conn.wbuf else 0
            )
            try:
                self.selector.register(conn.sock, events, ("conn", handler))
            except (KeyError, ValueError, OSError):
                pass

        self.post(_register)

    def want_write(self, conn: _Conn, enable: bool):
        def _modify():
            try:
                events = selectors.EVENT_READ | (
                    selectors.EVENT_WRITE if enable else 0
                )
                key = self.selector.get_key(conn.sock)
                if key.events != events:
                    self.selector.modify(conn.sock, events, key.data)
            except (KeyError, ValueError, OSError, RuntimeError):
                pass  # closed/unregistered during shutdown

        self.post(_modify)

    def send(self, conn: _Conn, data: bytes):
        with conn.lock:
            conn.wbuf += data
            if conn.want_w_pending:
                return  # write interest already requested/active
            conn.want_w_pending = True
        self.want_write(conn, True)

    def pump(self, conn: _Conn, mask: int, on_frames, on_close):
        """Common read/write pump for a connection."""
        if mask & selectors.EVENT_READ:
            try:
                chunk = conn.sock.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                chunk = None
            except OSError:
                chunk = b""
            if chunk == b"":
                self._close(conn, on_close)
                return
            if chunk:
                conn.rbuf += chunk
                try:
                    on_frames(conn)
                except ValueError:  # malformed frame: poisoned connection
                    self._close(conn, on_close)
                    return
        if mask & selectors.EVENT_WRITE:
            broken = False
            with conn.lock:
                if conn.wbuf:
                    try:
                        sent = conn.sock.send(conn.wbuf)
                        del conn.wbuf[:sent]
                    except (BlockingIOError, InterruptedError):
                        pass
                    except OSError:
                        broken = True
                if not broken and not conn.wbuf:
                    # a send() landing after the lock releases re-requests
                    # write interest itself (its modify posts AFTER this
                    # one in the IO-thread command queue, so the interest
                    # ends enabled)
                    conn.want_w_pending = False
                    self.want_write(conn, False)
            if broken:
                # outside conn.lock: close listeners re-take it (_on_close)
                self._close(conn, on_close)

    def _close(self, conn: _Conn, on_close):
        if not conn.open:
            return
        conn.open = False
        try:
            self.selector.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        on_close(conn)


class ConnectionHandle:
    """Server-side handle to one client connection: lets handlers push
    MESSAGE frames back to that client later (reference: the broker's
    ``SubscribedRecordWriter`` pushes job/topic subscription records down
    the client's own socket)."""

    def __init__(self, loop: _IoLoop, conn: _Conn):
        self._loop = loop
        self._conn = conn

    @property
    def open(self) -> bool:
        return self._conn.open

    @property
    def key(self) -> int:
        """Stable identity of the underlying connection. Handles are
        constructed per request, so handle identity cannot key
        per-connection state (the gateway's admission controller bounds
        in-flight commands PER CONNECTION by this key)."""
        return id(self._conn)

    def push(self, payload: bytes) -> bool:
        if not self._conn.open:
            return False
        self._loop.send(self._conn, _encode(MESSAGE, 0, payload))
        return True

    def on_close(self, listener: Callable[[], None]) -> None:
        """Run ``listener`` when this connection closes (reference: channel
        close listeners, used to tear down the peer's subscriptions). Fires
        immediately if the connection is already closed. The registration is
        atomic w.r.t. the IO thread's close path (conn.lock), so a listener
        cannot fall between the open-check and the close sweep."""
        with self._conn.lock:
            if self._conn.open:
                self._conn.close_listeners.append(listener)
                return
        listener()


class ServerTransport:
    """Accepts connections; dispatches REQUEST frames to ``request_handler``
    and MESSAGE frames to ``message_handler``. Handlers run on the IO
    thread — keep them short, or return an ``ActorFuture`` (async response:
    the reply is sent when the future completes, without blocking the IO
    loop — the reference's actor-dispatched request handling).

    ``request_handler`` may take ``(payload)`` or ``(payload, conn)`` — the
    two-argument form receives a :class:`ConnectionHandle` for later pushes.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        request_handler: Optional[Callable] = None,
        message_handler: Optional[Callable[[bytes], None]] = None,
    ):
        import inspect

        handler = request_handler or (lambda payload: None)
        try:
            params = inspect.signature(handler).parameters.values()
            positional = sum(
                1
                for p in params
                if p.kind
                in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            )
            takes_varargs = any(p.kind == p.VAR_POSITIONAL for p in params)
            self._handler_wants_conn = positional >= 2 or takes_varargs
        except (TypeError, ValueError):
            self._handler_wants_conn = False
        self.request_handler = handler
        self.message_handler = message_handler or (lambda payload: None)
        # chaos injection point for RESPONSE frames (see _deliver); pushes
        # through ConnectionHandle bypass it — the chaos plane severs RPC
        # by blocking the request direction
        self.fault_hook = None
        self._listener = socket.create_server((host, port))
        self._listener.setblocking(False)
        self.address = RemoteAddress(host, self._listener.getsockname()[1])
        self._loop = _IoLoop(f"zb-server-{self.address.port}")
        self._conns: Dict[socket.socket, _Conn] = {}
        self._loop.selector.register(
            self._listener, selectors.EVENT_READ, ("accept", self._accept)
        )
        self._loop.start()

    def _accept(self):
        try:
            sock, _addr = self._listener.accept()
        except (BlockingIOError, OSError):
            return
        conn = _Conn(sock)
        self._conns[sock] = conn
        self._loop.register_conn(conn, self._on_event)

    def _on_event(self, sock, mask):
        conn = self._conns.get(sock)
        if conn is None:
            return
        self._loop.pump(conn, mask, self._on_frames, self._on_close)

    def _on_frames(self, conn: _Conn):
        for ftype, cid, payload in conn.frames():
            if ftype == REQUEST:
                try:
                    if self._handler_wants_conn:
                        response = self.request_handler(
                            payload, ConnectionHandle(self._loop, conn)
                        )
                    else:
                        response = self.request_handler(payload)
                except Exception as e:  # noqa: BLE001
                    import traceback

                    traceback.print_exc()
                    response = None
                if isinstance(response, ActorFuture):
                    response.on_complete(
                        lambda f, c=conn, i=cid: self._send_async_response(c, i, f)
                    )
                elif response is not None:
                    _deliver(
                        self._loop, conn, None,
                        _encode(RESPONSE, cid, response), self.fault_hook,
                    )
            elif ftype == MESSAGE:
                try:
                    self.message_handler(payload)
                except Exception:  # noqa: BLE001
                    import traceback

                    traceback.print_exc()

    def _send_async_response(self, conn: _Conn, cid: int, future: ActorFuture):
        if future._exception is not None or future._value is None:
            return  # no response (caller times out, like a handler returning None)
        if conn.open:
            _deliver(
                self._loop, conn, None,
                _encode(RESPONSE, cid, future._value), self.fault_hook,
            )

    def _on_close(self, conn: _Conn):
        self._conns.pop(conn.sock, None)
        with conn.lock:
            conn.open = False
            listeners, conn.close_listeners = conn.close_listeners, []
        for listener in listeners:
            try:
                listener()
            except Exception:  # noqa: BLE001
                import traceback

                traceback.print_exc()

    def close(self):
        try:
            self._listener.close()
        except OSError:
            pass
        self._loop.stop()
        # fire close listeners for connections the loop never got to close —
        # retained ConnectionHandles must observe open == False and owners
        # (e.g. job subscriptions) must tear down
        for conn in list(self._conns.values()):
            self._on_close(conn)


class ClientTransport:
    """Connection pool + request correlation.

    ``send_request`` returns an ``ActorFuture`` completed with the response
    payload, failed fast with ``TransportError`` when the connection breaks
    or the timeout lapses. One failure mode is retried INTERNALLY: a request
    written to a stale pooled connection (the peer restarted since the last
    exchange, so the first write after the restart hits a dead socket)
    redials and resends once — callers must not see a ``TransportError``
    merely because the pool was behind reality (reference: ClientOutput
    retries on channel close before giving the failure to the request
    manager). All other failures surface; callers wanting retry-forever
    semantics loop and reconnect — the pool dials a fresh connection on the
    next send. ``send_message`` is fire-and-forget.
    """

    def __init__(
        self,
        default_timeout_ms: int = 5000,
        message_handler: Optional[Callable[[bytes], None]] = None,
    ):
        self.message_handler = message_handler
        self.fault_hook = None  # chaos injection point (see _deliver)
        self._loop = _IoLoop("zb-client").start()
        self._conns: Dict[RemoteAddress, _Conn] = {}
        self._by_sock: Dict[socket.socket, Tuple[RemoteAddress, _Conn]] = {}
        self._pending: Dict[int, Tuple[ActorFuture, float, "_Conn"]] = {}
        self._correlation = itertools.count(1)
        self._lock = threading.Lock()
        self._dialing: Dict[RemoteAddress, threading.Lock] = {}
        self.default_timeout_ms = default_timeout_ms
        self._timeout_thread = threading.Thread(
            target=self._expire_loop, name="zb-client-timeouts", daemon=True
        )
        self._closing = False
        self._timeout_thread.start()

    # -- connection management --------------------------------------------
    def _connect(self, addr: RemoteAddress) -> _Conn:
        with self._lock:
            conn = self._conns.get(addr)
            if conn is not None and conn.open:
                return conn
            dial_lock = self._dialing.setdefault(addr, threading.Lock())
        # serialize dials per address so concurrent callers share one socket
        with dial_lock:
            with self._lock:
                conn = self._conns.get(addr)
                if conn is not None and conn.open:
                    return conn
            sock = socket.create_connection((addr.host, addr.port), timeout=2.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(sock)
            with self._lock:
                self._conns[addr] = conn
                self._by_sock[sock] = (addr, conn)
            self._loop.register_conn(conn, self._on_event)
            return conn

    def _on_event(self, sock, mask):
        entry = self._by_sock.get(sock)
        if entry is None:
            return
        _addr, conn = entry
        self._loop.pump(conn, mask, self._on_frames, self._on_close)

    def _on_frames(self, conn: _Conn):
        for ftype, cid, payload in conn.frames():
            if ftype == MESSAGE:
                # server-initiated push (subscription records)
                if self.message_handler is not None:
                    try:
                        self.message_handler(payload)
                    except Exception:  # noqa: BLE001
                        import traceback

                        traceback.print_exc()
                continue
            if ftype != RESPONSE:
                continue
            with self._lock:
                entry = self._pending.pop(cid, None)
            if entry is not None:
                entry[0].complete(payload)

    def _on_close(self, conn: _Conn):
        """Fail this connection's in-flight requests immediately — callers
        see the broken connection now, not after the full timeout (they
        retry on a fresh connection; reference retry semantics live in the
        gateway's request manager)."""
        stale = []
        with self._lock:
            self._by_sock.pop(conn.sock, None)
            for addr, c in list(self._conns.items()):
                if c is conn:
                    del self._conns[addr]
            for cid, (future, _deadline, pconn) in list(self._pending.items()):
                if pconn is conn:
                    stale.append(future)
                    del self._pending[cid]
        for future in stale:
            future.complete_exceptionally(TransportError("connection closed"))

    def _expire_loop(self):
        while not self._closing:
            now = time.monotonic()
            expired = []
            nearest = None
            with self._lock:
                for cid, (future, deadline, _conn) in list(self._pending.items()):
                    if now >= deadline:
                        expired.append((cid, future))
                        del self._pending[cid]
                    elif nearest is None or deadline < nearest:
                        nearest = deadline
            if expired:
                _count_event("transport_pending_expired", delta=len(expired))
            for _cid, future in expired:
                future.complete_exceptionally(TransportError("request timed out"))
            # pace to the nearest deadline (bounded): a fixed 10ms scan of
            # the pending table burned real CPU on single-core serving
            # boxes while request timeouts are seconds-scale. The 0.1s cap
            # bounds how late a request registered AFTER this scan can
            # expire (the snapshot of `nearest` is stale by construction)
            pause = 0.1 if nearest is None else min(
                0.1, max(0.02, nearest - now)
            )
            time.sleep(pause)

    # -- public API --------------------------------------------------------
    def send_request(
        self,
        addr: RemoteAddress,
        payload: bytes,
        timeout_ms: Optional[int] = None,
    ) -> ActorFuture:
        future = ActorFuture()
        timeout = (timeout_ms or self.default_timeout_ms) / 1000.0
        self._send_attempt(addr, payload, future, time.monotonic() + timeout, retried=False)
        return future

    def _send_attempt(
        self,
        addr: RemoteAddress,
        payload: bytes,
        future: ActorFuture,
        deadline: float,
        retried: bool,
    ) -> None:
        # was there a live pooled connection BEFORE this attempt? Only those
        # qualify for the stale-connection retry: a connection dialed fresh
        # for this very request that immediately breaks is a real failure.
        with self._lock:
            existing = self._conns.get(addr)
        pooled = existing is not None and existing.open
        cid = next(self._correlation)
        try:
            conn = self._connect(addr)
        except OSError as e:
            future.complete_exceptionally(TransportError(f"connect to {addr}: {e}"))
            return
        inner = ActorFuture()
        with self._lock:
            self._pending[cid] = (inner, deadline, conn)

        def on_done(f: ActorFuture):
            if f._exception is None:
                future.complete(f._value)
                return
            if (
                pooled
                and not retried
                and not self._closing
                and "connection closed" in str(f._exception)
                and time.monotonic() < deadline
            ):
                # the pool's connection died under the request (peer
                # restarted): reconnect and resend once on a fresh socket.
                # On a dedicated thread — this callback runs on the IO
                # thread, and the redial blocks up to the connect timeout
                _count_event("transport_reconnects")
                threading.Thread(
                    target=self._send_attempt,
                    args=(addr, payload, future, deadline, True),
                    daemon=True,
                    name="zb-client-reconnect",
                ).start()
                return
            future.complete_exceptionally(f._exception)

        inner.on_complete(on_done)
        _deliver(self._loop, conn, addr, _encode(REQUEST, cid, payload), self.fault_hook)

    def send_message(self, addr: RemoteAddress, payload: bytes) -> bool:
        try:
            conn = self._connect(addr)
        except OSError:
            return False
        _deliver(self._loop, conn, addr, _encode(MESSAGE, 0, payload), self.fault_hook)
        return True

    def close(self):
        self._closing = True
        self._timeout_thread.join(timeout=2)
        self._loop.stop()
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for future, _deadline, _conn in pending:
            future.complete_exceptionally(TransportError("transport closed"))
