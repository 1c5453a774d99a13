"""SWIM gossip: membership, failure detection, dissemination.

Reference parity: ``gossip/`` — probe loop (``PingController``), indirect
probes (``PingReqEventHandler``), suspicion with timeout
(``SuspicionController`` semantics via the suspicion multiplier), alive
refutation by incarnation ("gossip term") bump, join + periodic anti-entropy
sync (``JoinController``, ``SyncController``), piggybacked membership and
custom events with a retransmission budget (``DisseminationComponent``,
``GossipMath.gossipPeriodsToSpread``), and custom-event listeners (how the
broker broadcasts partition/leader info; ``GossipCustomEventEncoding``).

Re-design: messages are msgpack maps over the shared TCP transport — PING /
PING-REQ / SYNC are request/response (the response doubles as the ACK with
piggyback), no bespoke SBE schema. The probe loop runs on the actor
scheduler; all state mutation is single-writer on the gossip actor.

Wire messages (msgpack maps):
  {t: "ping",     from: id, events: [...]}                → {t: "ack", from, events}
  {t: "ping-req", from: id, target: id, events: [...]}    → {t: "ack", ...} | {t: "nack"}
  {t: "sync",     from: id, addr: [h,p], events: [...]}   → {t: "sync-rsp", members: [...], events}
Events piggybacked everywhere:
  {e: "alive"|"suspect"|"confirm"|"custom", id, term, addr?, type?, payload?, seq?}
"""

from __future__ import annotations

import dataclasses
import enum
import math
import random
from typing import Any, Callable, Dict, List, Optional, Tuple

from zeebe_tpu_torch.protocol import msgpack
from zeebe_tpu_torch.runtime.actors import Actor, ActorFuture, ActorScheduler
from zeebe_tpu_torch.transport import ClientTransport, RemoteAddress, ServerTransport


class MemberStatus(enum.Enum):
    ALIVE = "alive"
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclasses.dataclass
class Member:
    member_id: str
    address: RemoteAddress
    status: MemberStatus = MemberStatus.ALIVE
    gossip_term: int = 0  # SWIM incarnation number
    suspect_since_ms: int = -1


@dataclasses.dataclass
class GossipConfig:
    """Reference: GossipConfiguration + the [gossip] section of
    zeebe.cfg.toml (probe interval/timeout, suspicion multiplier, sync)."""

    probe_interval_ms: int = 250
    probe_timeout_ms: int = 500
    probe_indirect_nodes: int = 2
    probe_indirect_timeout_ms: int = 1000
    suspicion_multiplier: int = 5
    sync_interval_ms: int = 10_000
    retransmission_multiplier: int = 3

    def suspicion_timeout_ms(self, cluster_size: int) -> int:
        return (
            self.suspicion_multiplier
            * max(1, math.ceil(math.log2(max(cluster_size, 2))))
            * self.probe_interval_ms
        )

    def retransmission_budget(self, cluster_size: int) -> int:
        # reference GossipMath.gossipPeriodsToSpread
        return self.retransmission_multiplier * max(
            1, math.ceil(math.log2(max(cluster_size, 2)))
        )


@dataclasses.dataclass
class _QueuedEvent:
    payload: dict
    remaining: int  # retransmission budget


class Gossip(Actor):
    """One node's gossip endpoint."""

    def __init__(
        self,
        member_id: str,
        scheduler: ActorScheduler,
        config: Optional[GossipConfig] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        rng: Optional[random.Random] = None,
    ):
        super().__init__(f"gossip-{member_id}")
        self.member_id = member_id
        self.config = config or GossipConfig()
        self.scheduler = scheduler
        self.rng = rng or random.Random(hash(member_id) & 0xFFFFFFFF)

        self.members: Dict[str, Member] = {}
        self._event_queue: List[_QueuedEvent] = []
        self._custom_seq = 0
        # highest custom-event seq seen per (sender id, type): dedup on relay
        self._custom_seen: Dict[Tuple[str, str], int] = {}
        self._custom_listeners: Dict[str, List[Callable[[str, Any], None]]] = {}
        self._membership_listeners: List[Callable[[Member], None]] = []
        self._probe_cursor = 0
        self._stopped = False

        self.server = ServerTransport(host=host, port=port, request_handler=self._on_request)
        self.client = ClientTransport(default_timeout_ms=self.config.probe_timeout_ms)
        self.self_member = Member(member_id, self.server.address)
        scheduler.submit_actor(self)  # zblint: disable=unobserved-actor-future (boot submit; start failures land in the scheduler failure ring)

    @property
    def address(self) -> RemoteAddress:
        return self.server.address

    # -- lifecycle ---------------------------------------------------------
    def on_actor_started(self) -> None:
        self.actor.run_at_fixed_rate(self.config.probe_interval_ms, self._probe_round)
        self.actor.run_at_fixed_rate(self.config.sync_interval_ms, self._sync_round)

    def close(self) -> None:
        self._stopped = True
        self.server.close()
        self.client.close()

    # -- public API --------------------------------------------------------
    def join(
        self, contact_points: List[RemoteAddress], max_rounds: int = 10
    ) -> ActorFuture:
        """Sync with the first reachable contact point; the whole list is
        retried with backoff before giving up (reference JoinController
        retries contact points on a timer)."""
        done = ActorFuture()

        def attempt(points: List[RemoteAddress], rounds_left: int):
            if not points:
                if rounds_left <= 0:
                    done.complete_exceptionally(
                        RuntimeError("no contact point reachable")
                    )
                    return
                self.actor.run_delayed(
                    self.config.probe_interval_ms,
                    lambda: attempt(list(contact_points), rounds_left - 1),
                )
                return
            addr, rest = points[0], points[1:]
            future = self.client.send_request(
                addr, self._encode_sync(), timeout_ms=self.config.probe_timeout_ms
            )

            def on_response(f: ActorFuture):
                if f._exception is not None:
                    self.actor.run(lambda: attempt(rest, rounds_left))
                    return
                self.actor.run(lambda: (self._apply_sync_response(f._value), done.complete()))

            future.on_complete(on_response)

        self.actor.run(lambda: attempt(list(contact_points), max_rounds))
        return done

    def leave(self) -> None:
        """Broadcast own death (graceful shutdown; reference Gossip.leave)."""

        def do_leave():
            self._enqueue_event(
                {
                    "e": "confirm",
                    "id": self.member_id,
                    "term": self.self_member.gossip_term,
                }
            )

        self.actor.run(do_leave)

    def publish_custom_event(self, event_type: str, payload: Any) -> None:
        """Disseminate an application event (reference publishEvent — the
        broker's topology broadcasts ride on this)."""

        def do_publish():
            self._custom_seq += 1
            event = {
                "e": "custom",
                "id": self.member_id,
                "type": event_type,
                "payload": payload,
                "seq": self._custom_seq,
            }
            self._custom_seen[(self.member_id, event_type)] = self._custom_seq
            self._enqueue_event(event)

        self.actor.run(do_publish)

    def on_custom_event(self, event_type: str, listener: Callable[[str, Any], None]) -> None:
        """listener(sender_id, payload); fires once per (sender, seq)."""
        self._custom_listeners.setdefault(event_type, []).append(listener)

    def on_membership_change(self, listener: Callable[[Member], None]) -> None:
        self._membership_listeners.append(listener)

    def alive_members(self) -> List[str]:
        out = [self.member_id]
        out += [m.member_id for m in self.members.values() if m.status == MemberStatus.ALIVE]
        return sorted(out)

    # -- wire encoding -----------------------------------------------------
    def _addr_list(self, addr: RemoteAddress) -> list:
        return [addr.host, addr.port]

    def _encode_msg(self, t: str, **fields) -> bytes:
        msg = {"t": t, "from": self.member_id, "events": self._drain_events()}
        msg.update(fields)
        return msgpack.pack(msg)

    def _encode_sync(self) -> bytes:
        return msgpack.pack(
            {
                "t": "sync",
                "from": self.member_id,
                "addr": self._addr_list(self.address),
                "events": [],
            }
        )

    # -- dissemination -----------------------------------------------------
    def _enqueue_event(self, payload: dict) -> None:
        budget = self.config.retransmission_budget(len(self.members) + 1)
        self._event_queue.append(_QueuedEvent(payload, budget))
        self._apply_event(payload, from_self=True)

    def _drain_events(self, limit: int = 16) -> List[dict]:
        """Piggyback up to ``limit`` queued events, decrementing budgets
        (reference DisseminationComponent.drainTo)."""
        out = []
        for qe in list(self._event_queue[:limit]):
            out.append(qe.payload)
            qe.remaining -= 1
            if qe.remaining <= 0:
                self._event_queue.remove(qe)
        return out

    # -- event application (membership state machine) ----------------------
    def _apply_events(self, events: List[dict]) -> None:
        for event in events or []:
            self._apply_event(event)

    def _apply_event(self, event: dict, from_self: bool = False) -> None:
        kind = event.get("e")
        member_id = event.get("id")
        if member_id is None:
            return
        if kind == "custom":
            self._apply_custom(event, from_self)
            return
        term = int(event.get("term", 0))
        if member_id == self.member_id:
            if kind in ("suspect", "confirm") and not from_self:
                # refute: bump incarnation, re-announce aliveness
                # (reference: alive-confirm on self suspicion)
                if term >= self.self_member.gossip_term:
                    self.self_member.gossip_term = term + 1
                    self._enqueue_event(
                        {
                            "e": "alive",
                            "id": self.member_id,
                            "term": self.self_member.gossip_term,
                            "addr": self._addr_list(self.address),
                        }
                    )
            return

        member = self.members.get(member_id)
        if kind == "alive":
            addr = event.get("addr")
            if member is None:
                if addr is None:
                    return
                member = Member(
                    member_id, RemoteAddress(addr[0], int(addr[1])), MemberStatus.ALIVE, term
                )
                self.members[member_id] = member
                self._relay(event)
                self._notify_membership(member)
            elif term > member.gossip_term or (
                term == member.gossip_term and member.status == MemberStatus.DEAD
            ):
                member.gossip_term = term
                changed = member.status != MemberStatus.ALIVE
                member.status = MemberStatus.ALIVE
                member.suspect_since_ms = -1
                self._relay(event)
                if changed:
                    self._notify_membership(member)
        elif kind == "suspect":
            if member is None or member.status == MemberStatus.DEAD:
                return
            if term >= member.gossip_term and member.status == MemberStatus.ALIVE:
                member.gossip_term = term
                member.status = MemberStatus.SUSPECT
                member.suspect_since_ms = self.scheduler.now_ms()
                self._relay(event)
                self._notify_membership(member)
        elif kind == "confirm":
            if member is None or member.status == MemberStatus.DEAD:
                return
            # a confirm is authoritative: only a LATER alive term refutes it
            member.status = MemberStatus.DEAD
            member.gossip_term = max(member.gossip_term, term)
            self._relay(event)
            self._notify_membership(member)

    def _apply_custom(self, event: dict, from_self: bool) -> None:
        sender = event["id"]
        if sender == self.member_id and not from_self:
            return
        key = (sender, event.get("type", ""))
        seq = int(event.get("seq", 0))
        if not from_self:
            if seq <= self._custom_seen.get(key, 0):
                return
            self._custom_seen[key] = seq
            self._relay(event)
        for listener in self._custom_listeners.get(event.get("type", ""), []):
            listener(sender, event.get("payload"))

    def _relay(self, event: dict) -> None:
        budget = self.config.retransmission_budget(len(self.members) + 1)
        self._event_queue.append(_QueuedEvent(dict(event), budget))

    def _notify_membership(self, member: Member) -> None:
        for listener in self._membership_listeners:
            listener(member)

    # -- probe loop (failure detection) ------------------------------------
    def _probe_targets(self) -> List[Member]:
        return [m for m in self.members.values() if m.status != MemberStatus.DEAD]

    def _probe_round(self) -> None:
        if self._stopped:
            return
        self._expire_suspects()
        targets = self._probe_targets()
        if not targets:
            return
        self._probe_cursor = (self._probe_cursor + 1) % len(targets)
        target = targets[self._probe_cursor]
        ping = self._encode_msg("ping")
        future = self.client.send_request(
            target.address, ping, timeout_ms=self.config.probe_timeout_ms
        )

        def on_ack(f: ActorFuture):
            if f._exception is None:
                self.actor.run(lambda: self._on_ack(target, f._value))
            else:
                self.actor.run(lambda: self._indirect_probe(target))

        future.on_complete(on_ack)

    def _on_ack(self, member: Member, payload: bytes) -> None:
        try:
            msg = msgpack.unpack(payload)
        except Exception:  # noqa: BLE001
            return
        self._apply_events(msg.get("events"))

    def _indirect_probe(self, target: Member) -> None:
        """Reference PingReqEventHandler: ask k peers to probe on our
        behalf before suspecting."""
        if self._stopped or target.status == MemberStatus.DEAD:
            return
        peers = [m for m in self._probe_targets() if m.member_id != target.member_id]
        self.rng.shuffle(peers)
        peers = peers[: self.config.probe_indirect_nodes]
        if not peers:
            self._suspect(target)
            return
        pending = [len(peers)]
        confirmed = [False]

        def on_result(f: ActorFuture):
            def apply():
                pending[0] -= 1
                ok = False
                if f._exception is None:
                    try:
                        ok = msgpack.unpack(f._value).get("t") == "ack"
                    except Exception:  # noqa: BLE001
                        ok = False
                if ok:
                    confirmed[0] = True
                if pending[0] == 0 and not confirmed[0]:
                    self._suspect(target)

            self.actor.run(apply)

        request = self._encode_msg("ping-req", target=target.member_id)
        for peer in peers:
            self.client.send_request(
                peer.address, request, timeout_ms=self.config.probe_indirect_timeout_ms
            ).on_complete(on_result)

    def _suspect(self, member: Member) -> None:
        if member.status != MemberStatus.ALIVE:
            return
        self._apply_event(
            {"e": "suspect", "id": member.member_id, "term": member.gossip_term}
        )

    def _expire_suspects(self) -> None:
        timeout = self.config.suspicion_timeout_ms(len(self.members) + 1)
        now = self.scheduler.now_ms()
        for member in list(self.members.values()):
            if (
                member.status == MemberStatus.SUSPECT
                and now - member.suspect_since_ms >= timeout
            ):
                self._apply_event(
                    {"e": "confirm", "id": member.member_id, "term": member.gossip_term}
                )

    # -- sync (anti-entropy) ----------------------------------------------
    def _sync_round(self) -> None:
        if self._stopped:
            return
        targets = self._probe_targets()
        if not targets:
            return
        target = self.rng.choice(targets)
        future = self.client.send_request(
            target.address, self._encode_sync(), timeout_ms=self.config.probe_timeout_ms
        )

        def on_response(f: ActorFuture):
            if f._exception is None:
                self.actor.run(lambda: self._apply_sync_response(f._value))

        future.on_complete(on_response)

    def _member_snapshot(self) -> List[dict]:
        out = [
            {
                "id": self.member_id,
                "term": self.self_member.gossip_term,
                "status": MemberStatus.ALIVE.value,
                "addr": self._addr_list(self.address),
            }
        ]
        for m in self.members.values():
            out.append(
                {
                    "id": m.member_id,
                    "term": m.gossip_term,
                    "status": m.status.value,
                    "addr": self._addr_list(m.address),
                }
            )
        return out

    def _apply_sync_response(self, payload: bytes) -> None:
        try:
            msg = msgpack.unpack(payload)
        except Exception:  # noqa: BLE001
            return
        for entry in msg.get("members", []):
            status = entry.get("status")
            event = {
                "e": "alive" if status == "alive" else ("suspect" if status == "suspect" else "confirm"),
                "id": entry["id"],
                "term": int(entry.get("term", 0)),
                "addr": entry.get("addr"),
            }
            self._apply_event(event)
        self._apply_events(msg.get("events"))

    # -- request handling (IO thread: decode only, then hop to the actor;
    # responses are async futures so the IO loop never blocks) -------------
    def _on_request(self, payload: bytes):
        try:
            msg = msgpack.unpack(payload)
        except Exception:  # noqa: BLE001
            return None
        t = msg.get("t")
        if t == "ping":
            return self.actor.call(lambda: self._handle_ping(msg))
        if t == "ping-req":
            result = ActorFuture()
            self.actor.run(lambda: self._handle_ping_req(msg, result))
            return result
        if t == "sync":
            return self.actor.call(lambda: self._handle_sync(msg))
        return None

    def _handle_ping(self, msg: dict) -> bytes:
        self._apply_events(msg.get("events"))
        return self._encode_msg("ack")

    def _handle_ping_req(self, msg: dict, result: ActorFuture) -> None:
        """Probe ``target`` on behalf of the requester (reference
        PingReqEventHandler); runs on the gossip actor, completes the
        response future when the relayed probe answers."""
        self._apply_events(msg.get("events"))
        target = self.members.get(msg.get("target"))
        if target is None:
            result.complete(msgpack.pack({"t": "nack", "from": self.member_id}))
            return
        relay = self.client.send_request(
            target.address, self._encode_msg("ping"),
            timeout_ms=self.config.probe_timeout_ms,
        )

        def on_relay(f: ActorFuture):
            def apply():
                if f._exception is not None:
                    result.complete(
                        msgpack.pack({"t": "nack", "from": self.member_id})
                    )
                    return
                self._on_ack(target, f._value)
                result.complete(self._encode_msg("ack"))

            self.actor.run(apply)

        relay.on_complete(on_relay)

    def _handle_sync(self, msg: dict) -> bytes:
        self._apply_events(msg.get("events"))
        addr = msg.get("addr")
        sender = msg.get("from")
        if sender and addr and sender != self.member_id:
            self._apply_event(
                {"e": "alive", "id": sender, "term": 0, "addr": addr}
            )
        return msgpack.pack(
            {
                "t": "sync-rsp",
                "from": self.member_id,
                "members": self._member_snapshot(),
                "events": self._drain_events(),
            }
        )
