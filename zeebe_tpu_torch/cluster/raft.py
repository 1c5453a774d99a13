"""Raft consensus: per-partition log replication.

Reference parity: ``raft/`` — one raft actor per partition replicating the
partition's log stream (``Raft.java:85``), follower/candidate/leader states
(``raft/.../state/``), poll-before-vote elections (``RaftPollService`` —
the pre-vote that avoids term inflation from partitioned nodes), leader
replication via per-member controllers walking the log and shipping
``AppendRequest``s (``MemberReplicateLogController.java:46-199``), quorum
commit = sorted match positions at index ``n - quorum``
(``LeaderState.java:171-199`` keeps ``positions[n+1-quorum]`` of n+1
members), persistent term/votedFor/members (``RaftPersistentStorage``),
and membership change via configuration events on the log
(``RaftConfigurationEvent``; single-step here instead of joint consensus —
one config change may be in flight at a time).

Re-design: messages are msgpack maps over the shared TCP transport (no SBE
schema); log entries travel as the codec's record frames. All state
mutation is single-writer on the raft actor.

Wire (msgpack maps, all request/response):
  poll / vote: {t, term, candidate, last_position, last_term}
               → {granted: bool, term}
  append:      {t: "append", term, leader, prev_position, prev_term,
                commit, frames: bytes}
               → {t: "append-rsp", term, success, match_position}
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import random
import threading
from typing import Callable, Dict, List, Optional

from zeebe_tpu_torch._events import count_event as _count_event
from zeebe_tpu_torch.tracing.recorder import record_event as _flight
from zeebe_tpu_torch.log.logstream import LogStream
from zeebe_tpu_torch.protocol import codec, msgpack
from zeebe_tpu_torch.runtime.actors import Actor, ActorFuture, ActorScheduler
from zeebe_tpu_torch.transport import ClientTransport, RemoteAddress, ServerTransport


class RaftState(enum.Enum):
    FOLLOWER = "follower"
    CANDIDATE = "candidate"
    LEADER = "leader"


@dataclasses.dataclass
class RaftConfig:
    """Reference: the [raft] section of zeebe.cfg.toml (250ms heartbeat,
    1s election timeout)."""

    heartbeat_interval_ms: int = 100
    election_timeout_ms: int = 400
    election_jitter_ms: int = 400
    replication_batch_records: int = 128
    # per-peer RPC backoff: after a failed append/poll/vote exchange the
    # peer is not re-contacted for base * 2^(failures-1) ms (+ jitter),
    # capped at max — a dead or partitioned-away peer must not be hammered
    # at the full heartbeat rate (bare re-sends amplified exactly when the
    # cluster was least healthy)
    rpc_backoff_base_ms: int = 50
    rpc_backoff_max_ms: int = 2000
    # commit-latency watchdog: a leader holding appends un-COMMITTED for
    # longer than this logs + counts + flight-records the stall (the
    # "commit stuck at the no-op" failure class)
    commit_stall_ms: int = 5000


class RaftPersistentStorage:
    """Durable (term, voted_for, members) — reference RaftPersistentStorage
    writes a small metadata file per partition."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self.term = 0
        self.voted_for: Optional[str] = None
        self.members: Dict[str, List] = {}  # member id → [host, port]
        if path and os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            self.term = data.get("term", 0)
            self.voted_for = data.get("voted_for")
            self.members = data.get("members", {})

    def save(self) -> None:
        if not self.path:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {"term": self.term, "voted_for": self.voted_for, "members": self.members},
                f,
            )
            f.flush()
            # raft safety: term/vote must be durable before answering any
            # RPC — an async fsync would reintroduce the double-vote window
            # zblint: disable=actor-thread-blocking (deliberate sync fsync)
            os.fsync(f.fileno())
        os.replace(tmp, self.path)


class Raft(Actor):
    """One node's raft endpoint for one partition."""

    def __init__(
        self,
        node_id: str,
        log: LogStream,
        scheduler: ActorScheduler,
        config: Optional[RaftConfig] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        storage_path: Optional[str] = None,
        rng: Optional[random.Random] = None,
    ):
        super().__init__(f"raft-{node_id}")
        self.node_id = node_id
        self.log = log
        self.scheduler = scheduler
        self.config = config or RaftConfig()
        self.rng = rng or random.Random(hash(node_id) & 0xFFFFFFFF)

        self.persistent = RaftPersistentStorage(storage_path)
        self.state = RaftState.FOLLOWER
        self.leader_id: Optional[str] = None
        self.votes: set = set()
        self.polls: set = set()
        # leader replication state: member id → next position to ship
        self.next_position: Dict[str, int] = {}
        self.match_position: Dict[str, int] = {}
        self._last_heartbeat_ms = 0
        self._election_deadline_ms = 0
        # per-peer RPC backoff state: member id → (consecutive_failures,
        # earliest retry time in scheduler ms); see RaftConfig.rpc_backoff_*
        self._peer_backoff: Dict[str, tuple] = {}
        # set when the leader probes us with snapshot_needed (we are below
        # its compaction floor); the snapshot-replication service reads it
        # to decide a log fast-forward is legitimate
        self.snapshot_needed = False
        # applied config entries (position, members) for truncate rollback:
        # single-step membership applies ON APPEND, so removing the entry
        # from the log must revert to the previous configuration
        self._config_log: List[tuple] = []
        self._self_removal_position: Optional[int] = None
        self._state_listeners: List[Callable[[RaftState, int], None]] = []
        self._stopped = False
        # group-commit queue: append() calls enqueue here and one drain job
        # on the raft actor appends EVERYTHING queued as one log append +
        # one durability flush (see append)
        self._append_queue: List[tuple] = []
        self._append_lock = threading.Lock()
        # appended-but-uncommitted caller futures: (first, last, enq_ms,
        # future), resolved when the commit position covers them and
        # FAILED when a new leader's replication truncates them — acked
        # means COMMITTED (see append()). Guarded by _append_lock (the
        # drain registers on the raft actor; close() may fail them from
        # another thread).
        self._pending_commits: List[tuple] = []
        self._commit_stall_warned = False
        # log positions THIS raft bound sampled spans to (as leader, in
        # _stamp_traced_appends): truncation cleanup touches only these,
        # because the tracer is process-global and an in-process peer's
        # follower-side truncate must not finish the real leader's live
        # spans. Raft-actor-only state (append/resolve/truncate all run
        # there); pruned as commits cover it, so it stays sampled-sized.
        self._traced_bound: set = set()

        self.server = ServerTransport(host=host, port=port, request_handler=self._on_request)
        self.client = ClientTransport(default_timeout_ms=1000)
        scheduler.submit_actor(self)  # zblint: disable=unobserved-actor-future (boot submit; start failures land in the scheduler failure ring)

    # -- public API --------------------------------------------------------
    @property
    def address(self) -> RemoteAddress:
        return self.server.address

    @property
    def term(self) -> int:
        return self.persistent.term

    def bootstrap(self, members: Dict[str, RemoteAddress]) -> None:
        """Install the initial static membership (reference: persisted
        configuration from partition creation). Includes self."""

        def do():
            self.persistent.members = {
                mid: [a.host, a.port] for mid, a in members.items()
            }
            self.persistent.save()
            self._reset_election_timer()

        self.actor.run(do)

    def on_state_change(self, listener: Callable[[RaftState, int], None]) -> None:
        """listener(new_state, term); fires on this node's transitions
        (reference onStateChange → PartitionInstallService)."""
        self._state_listeners.append(listener)

    def append(self, records: List) -> ActorFuture:
        """Leader-only: append records to the replicated log. Completes
        with the last position once the records are COMMITTED (quorum-
        replicated), and completes exceptionally when they are lost —
        deposed before the drain ran, or truncated off this node's log by
        a new leader's replication.

        Acked-means-committed is the liveness contract the old
        acked-on-local-durability version broke: an append landing on a
        leader that was already deposed (but had not yet heard the new
        term) returned success for records the new leader then truncated,
        so a caller retrying only on FAILURE hung forever waiting for a
        commit that could never come (the recorded
        ``test_appends_replicate_and_commit`` flake — commit stuck at the
        no-op). Now that window resolves the future exceptionally and the
        caller's retry lands on the real leader. Retries are
        at-least-once: a failed future's records MAY still commit if the
        new leader already replicated them (standard raft "leadership
        lost" ambiguity; the client-level cid dedup covers commands).

        GROUP COMMIT: calls that queue while the raft actor is busy drain
        as ONE ``log.append`` + ONE durability flush (fsync) + one
        replication fan-out, in call order. Frames stay byte-identical to
        individual appends (per-record codec framing is unchanged) — only
        the fsync/replication round-trip count amortizes, which is the
        serving path's per-command floor."""
        future = ActorFuture()
        with self._append_lock:
            self._append_queue.append((records, future))
            first = len(self._append_queue) == 1
        if first:  # one drain job per burst; later calls ride it
            self.actor.run(self._drain_appends)
        return future

    def _drain_appends(self) -> None:
        with self._append_lock:
            batch, self._append_queue = self._append_queue, []
        if not batch:
            return
        if self._stopped:
            # close() already swept _pending_commits; a drain landing
            # after that sweep must not append or register new pending
            # entries — nothing would ever resolve them
            for _records, future in batch:
                future.complete_exceptionally(RuntimeError("raft closed"))
            return
        if self.state != RaftState.LEADER:
            for _records, future in batch:
                future.complete_exceptionally(RuntimeError("not leader"))
            return
        from zeebe_tpu_torch.protocol.columnar import ColumnarBatch, MixedBatch

        term = self.persistent.term
        columnar = False
        for records, _future in batch:
            if isinstance(records, ColumnarBatch):
                # device-emission follow-ups arrive as a lazy batch: the
                # term stamps onto the COLUMN (lazy rows pick it up at
                # materialization), never forcing a row build here
                records.set_raft_term(term)
                columnar = True
            else:
                for record in records:
                    record.raft_term = term
        if not columnar:
            merged: List = []
            for records, _future in batch:
                merged.extend(records)
        elif len(batch) == 1:
            merged = batch[0][0]
        else:
            # a coalesced group with a columnar member: merge the groups'
            # tail ENTRIES (real rows + lazy refs) in call order — the
            # combined batch still encodes in one pass, rows stay lazy
            entries: List = []
            for records, _future in batch:
                if isinstance(records, ColumnarBatch):
                    entries.extend(records.log_entries())
                else:
                    entries.extend(records)
            merged = MixedBatch(entries)
        group_sizes = [len(records) for records, _future in batch]
        try:
            last = self.log.append(merged, commit=False)
            self.log.flush()  # ONE durable fsync for the whole group
        except Exception as e:
            # storage failure (e.g. closed mid-shutdown): fail every
            # queued caller instead of leaving futures to hang
            for _records, future in batch:
                future.complete_exceptionally(e)
            raise
        if len(batch) > 1:
            _count_event(
                "log_group_commit_coalesced",
                "append() calls that shared another call's fsync",
                delta=len(batch) - 1,
            )
        # positions are dense over the merged group: each caller's last
        # position derives from its slice, with no row materialization
        first = last - len(merged) + 1 if len(merged) else last + 1
        end = 0
        now = self.scheduler.now_ms()
        with self._append_lock:
            # close() flips _stopped before sweeping under this lock, so
            # re-checking here is race-free: registering after the sweep
            # would leave the futures with no resolver
            stopped = self._stopped
            for (records, future), size in zip(batch, group_sizes):
                end += size
                if stopped:
                    future.complete_exceptionally(RuntimeError("raft closed"))
                elif size:
                    self._pending_commits.append(
                        (first + end - size, first + end - 1, now, future)
                    )
                else:  # nothing to commit-wait on
                    future.complete(last)
        self._stamp_traced_appends(batch)
        self.match_position[self.node_id] = last
        self._maybe_commit()
        self._replicate_all()

    def _stamp_traced_appends(self, batch) -> None:
        """Record-lifecycle tracing: bind sampled client commands to the
        log positions this group commit just assigned (stamps RAFT_FSYNC).
        One global read when tracing is off; one dict-truthiness read when
        no request spans are live."""
        from zeebe_tpu_torch import tracing

        tracer = tracing.TRACER
        if tracer is None or not tracer.tracking_requests():
            return
        pid = getattr(self.log, "partition_id", 0)
        for records, _future in batch:
            if not isinstance(records, list):
                continue  # columnar emissions carry no client request ids
            for record in records:
                rid = getattr(record.metadata, "request_id", -1)
                if rid is not None and rid >= 0:
                    if tracer.bind_append(rid, pid, record.position):
                        self._traced_bound.add(record.position)

    def _resolve_pending_commits(self) -> None:
        """Complete append futures whose spans the commit position now
        covers (acked means committed). Runs on the raft actor — both the
        leader's quorum commit and a deposed leader learning the new
        leader's commit resolve here."""
        commit = self.log.commit_position
        if self._traced_bound:
            # committed positions can never be truncated ("commit is
            # final"): stop tracking them for truncation cleanup
            self._traced_bound = {
                p for p in self._traced_bound if p > commit
            }
        done: List[tuple] = []
        with self._append_lock:
            if not self._pending_commits:
                return
            keep = []
            for entry in self._pending_commits:
                (done if entry[1] <= commit else keep).append(entry)
            self._pending_commits = keep
            if done or not keep:
                # progress ends a stall episode even when newer pendings
                # remain (sustained load never drains to empty): a later
                # wedge must warn and count again
                self._commit_stall_warned = False
        for _first, last_pos, _enq, future in done:
            future.complete(last_pos)

    def on_snapshot_fast_forward(self) -> None:
        """Snapshot catch-up reset the log underneath raft (fast_forward
        discards everything below the snapshot boundary and jumps the
        commit position without going through set_commit_position): every
        pending append future references superseded positions and would
        otherwise hang forever. Fail them all — the records MAY have
        committed cluster-wide (the snapshot covers them; standard
        leadership-lost at-least-once ambiguity) — so callers retry on
        the real leader, and finish their bound spans before the
        positions are re-served."""
        self._fail_pending_from(0, "snapshot fast-forward")

    def _fail_pending_from(self, position: int, reason: str) -> None:
        """A truncate removed everything from ``position`` on: append
        futures whose span intersects the cut lost records — fail them so
        callers retry on the real leader instead of waiting forever."""
        from zeebe_tpu_torch import tracing

        tracer = tracing.TRACER
        if tracer is not None and self._traced_bound:
            # the cut records no longer exist and their positions will be
            # reused by the new leader: finish the bound spans so a later
            # commit over a reused position cannot mis-stamp a dead trace.
            # BEFORE the empty-pendings return — a second truncate walking
            # further back can arrive with no pendings left but live spans
            # still bound in the newly-cut range. Restricted to positions
            # THIS raft bound: the tracer is process-global, and a
            # follower-side truncate must not finish the in-process
            # leader's live spans
            mine = {p for p in self._traced_bound if p >= position}
            if mine:
                tracer.truncate_positions_from(
                    getattr(self.log, "partition_id", 0), position,
                    only=mine,
                )
                self._traced_bound -= mine
        failed: List[tuple] = []
        with self._append_lock:
            if not self._pending_commits:
                return
            keep = []
            for entry in self._pending_commits:
                (failed if entry[1] >= position else keep).append(entry)
            self._pending_commits = keep
            if failed or not keep:
                # the stall episode (if any) ended with the cut pendings:
                # re-arm the watchdog for the next one
                self._commit_stall_warned = False
        if failed:
            _count_event(
                "raft_appends_truncated",
                "Acked-pending append futures failed because a new "
                "leader's replication truncated their records",
                delta=len(failed),
            )
            _flight(
                "raft", "pending appends truncated", node=self.node_id,
                term=self.persistent.term, position=position,
                futures=len(failed), reason=reason,
            )
        for _first, _last, _enq, future in failed:
            future.complete_exceptionally(
                RuntimeError(f"not leader: {reason}")
            )

    # membership ops retry/forward for this long before giving up — a
    # leadership flap mid-call must not surface "not leader" to callers
    # (reference RaftJoinService retries joins until a leader accepts)
    MEMBERSHIP_TIMEOUT_MS = 10_000
    _MEMBERSHIP_RETRY_MS = 150

    def add_member(self, member_id: str, addr: RemoteAddress) -> ActorFuture:
        """Single-step membership change: appends a configuration entry
        with the new member set; the configuration takes effect ON APPEND
        (reference RaftConfigurationEvent / RaftJoinService; raft
        dissertation §4.1 — one change in flight at a time is the caller's
        responsibility). May be called on ANY node: a non-leader forwards
        the op to the current leader and retries across leadership flaps
        until ``MEMBERSHIP_TIMEOUT_MS``."""
        return self._change_membership(
            {"op": "add", "member": member_id, "addr": [addr.host, addr.port]}
        )

    def remove_member(self, member_id: str) -> ActorFuture:
        return self._change_membership({"op": "remove", "member": member_id})

    @staticmethod
    def _membership_mutation(op: dict):
        if op["op"] == "add":
            return lambda m: {**m, op["member"]: list(op["addr"])}
        return lambda m: {k: v for k, v in m.items() if k != op["member"]}

    def _change_membership(self, op: dict) -> ActorFuture:
        future = ActorFuture()
        deadline = self.scheduler.now_ms() + self.MEMBERSHIP_TIMEOUT_MS

        def attempt():
            if future.is_done():
                return
            if self._stopped:
                future.complete_exceptionally(RuntimeError("raft closed"))
                return
            if self.state == RaftState.LEADER:
                try:
                    future.complete(self._apply_membership_as_leader(op))
                except Exception as e:  # noqa: BLE001
                    future.complete_exceptionally(e)
                return
            # not the leader: forward to the leader we know of, or wait
            # out the election and retry
            target = self._membership_forward_target()
            if target is None:
                retry_later()
                return
            request = msgpack.pack({"t": "membership", **op})

            def on_response(msg):
                if future.is_done():
                    return
                if msg is not None and msg.get("ok"):
                    future.complete(int(msg.get("position", -1)))
                elif msg is not None and msg.get("error"):
                    # the leader ACCEPTED leadership of the op but failed
                    # applying it (e.g. log write error) — that is a real
                    # failure, not a redirect; surface it instead of
                    # retrying into the same error for 10s
                    future.complete_exceptionally(
                        RuntimeError(f"membership change failed: {msg['error']}")
                    )
                else:
                    retry_later()

            self._ask(target, request, on_response)

        def retry_later():
            if self.scheduler.now_ms() >= deadline:
                future.complete_exceptionally(
                    RuntimeError(
                        f"membership change {op['op']} {op['member']!r} "
                        f"timed out after {self.MEMBERSHIP_TIMEOUT_MS}ms "
                        "(no leader accepted it)"
                    )
                )
                return
            self.actor.run_delayed(self._MEMBERSHIP_RETRY_MS, attempt)

        self.actor.run(attempt)
        return future

    def _membership_forward_target(self) -> Optional[RemoteAddress]:
        """Address of the node to forward a membership op to: the current
        leader if known, else None (caller retries after the election)."""
        if self.leader_id is None or self.leader_id == self.node_id:
            return None
        entry = self.persistent.members.get(self.leader_id)
        if entry is None:
            return None
        return RemoteAddress(entry[0], int(entry[1]))

    def _apply_membership_as_leader(self, op: dict) -> int:
        """Leader-side config append (must run on the raft actor while
        leader). Returns the config entry's position."""
        from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
        from zeebe_tpu_torch.protocol.metadata import RecordMetadata
        from zeebe_tpu_torch.protocol.records import RaftConfigurationRecord, Record

        mutate = self._membership_mutation(op)
        new_members = mutate(dict(self.persistent.members))
        record = Record(
            metadata=RecordMetadata(
                record_type=RecordType.EVENT,
                value_type=ValueType.RAFT,
                intent=0,
            ),
            value=RaftConfigurationRecord(members=new_members),
        )
        record.raft_term = self.persistent.term
        last = self.log.append([record], commit=False)
        self.log.flush()
        self._config_log.append((last, dict(self.persistent.members)))
        self._apply_config(new_members)
        if self.node_id not in new_members:
            self._self_removal_position = last
        self.match_position[self.node_id] = last
        self._maybe_commit()
        self._replicate_all()
        return last

    def _apply_config(self, members: Dict[str, list]) -> None:
        self.persistent.members = dict(members)
        self.persistent.save()
        if self.state == RaftState.LEADER:
            last, _ = self._last_entry()
            for mid in self._other_members():
                self.next_position.setdefault(mid, last + 1)
                self.match_position.setdefault(mid, -1)
            for mid in list(self.next_position):
                if mid not in self.persistent.members:
                    self.next_position.pop(mid, None)
                    self.match_position.pop(mid, None)
            # a leader removing ITSELF keeps leading until the removal
            # entry COMMITS (dissertation §4.2.2: it manages the cluster
            # through the transition, not counting itself toward quorum —
            # _maybe_commit already iterates only current members), then
            # steps aside. Stepping down immediately would orphan the
            # un-replicated entry.

    def _maybe_apply_config(self, record) -> None:
        from zeebe_tpu_torch.protocol.enums import ValueType

        if int(record.metadata.value_type) == int(ValueType.RAFT):
            members = getattr(record.value, "members", None)
            if isinstance(members, dict) and members:
                self._config_log.append(
                    (record.position, dict(self.persistent.members))
                )
                self._apply_config(members)

    def _rollback_config(self, position: int) -> None:
        """Truncating a suffix that contained configuration entries must
        revert to the configuration in force before them (raft dissertation
        §4.1: config-on-append implies config-rollback-on-truncate)."""
        reverted = None
        while self._config_log and self._config_log[-1][0] >= position:
            _pos, previous = self._config_log.pop()
            reverted = previous
        if reverted is not None:
            self._apply_config(reverted)

    def close(self) -> None:
        self._stopped = True
        with self._append_lock:
            pending, self._pending_commits = self._pending_commits, []
            self._commit_stall_warned = False
        for _first, _last, _enq, future in pending:
            future.complete_exceptionally(RuntimeError("raft closed"))
        self.server.close()
        self.client.close()

    # -- lifecycle ---------------------------------------------------------
    def on_actor_started(self) -> None:
        self._reset_election_timer()
        self.actor.run_at_fixed_rate(
            self.config.heartbeat_interval_ms, self._tick
        )

    def _members(self) -> Dict[str, RemoteAddress]:
        return {
            mid: RemoteAddress(a[0], int(a[1]))
            for mid, a in self.persistent.members.items()
        }

    def _quorum(self) -> int:
        return len(self.persistent.members) // 2 + 1

    def _other_members(self) -> Dict[str, RemoteAddress]:
        members = self._members()
        members.pop(self.node_id, None)
        return members

    def _reset_election_timer(self) -> None:
        self._election_deadline_ms = (
            self.scheduler.now_ms()
            + self.config.election_timeout_ms
            + self.rng.randrange(self.config.election_jitter_ms + 1)
        )

    # -- per-peer RPC backoff ----------------------------------------------
    # Scope: the backoff gates only the APPEND path (_replicate_one), which
    # re-sends at the heartbeat rate. Election poll/vote sends are NOT
    # gated — they are already paced and jittered by the election timer
    # (one send per member per timeout), and skipping a just-healed peer
    # there would stretch the leaderless window by up to the max backoff.
    # Poll/vote responses still feed the failure accounting, so a dead
    # peer discovered during an election is backed off on the append path.
    def _peer_backed_off(self, member_id: str) -> bool:
        entry = self._peer_backoff.get(member_id)
        return entry is not None and self.scheduler.now_ms() < entry[1]

    def _note_peer_failure(self, member_id: str) -> None:
        """A request to this peer failed (no/undecodable response): back off
        exponentially with jitter before contacting it again.

        Failures landing while the peer is ALREADY backed off don't
        escalate: one outage kills every in-flight request at once (several
        heartbeat-interval appends share the request-timeout window), and
        counting that burst as N failures would jump the delay straight to
        the max instead of ramping 1x, 2x, 4x per retry round."""
        entry = self._peer_backoff.get(member_id, (0, 0))
        if self.scheduler.now_ms() < entry[1]:
            return
        failures = entry[0] + 1
        delay = min(
            self.config.rpc_backoff_max_ms,
            self.config.rpc_backoff_base_ms * (1 << min(failures - 1, 16)),
        )
        delay += self.rng.randrange(delay // 2 + 1)  # jitter: desynchronize
        self._peer_backoff[member_id] = (
            failures, self.scheduler.now_ms() + delay
        )

    def _note_peer_ok(self, member_id: str) -> None:
        self._peer_backoff.pop(member_id, None)

    def _become(self, state: RaftState) -> None:
        if self.state == state:
            return
        self.state = state
        _flight(
            "raft", f"state -> {state.value}", node=self.node_id,
            term=self.persistent.term, partition=getattr(
                self.log, "partition_id", 0
            ),
        )
        for listener in self._state_listeners:
            listener(state, self.persistent.term)

    def _tick(self) -> None:
        if self._stopped or not self.persistent.members:
            return
        if self.state == RaftState.LEADER:
            self._check_commit_stall()
            self._replicate_all()
            return
        if self.scheduler.now_ms() >= self._election_deadline_ms:
            self._start_poll()

    def _check_commit_stall(self) -> None:
        """Commit-latency watchdog: a leader sitting on appends that never
        commit is exactly the silent failure mode the recorded replication
        flake had — warn ONCE per stall episode with the flight-recorder
        slice, count it, and leave forensics in the ring."""
        with self._append_lock:
            if not self._pending_commits:
                return
            oldest = self._pending_commits[0]
            stalled = (
                self.scheduler.now_ms() - oldest[2]
                > self.config.commit_stall_ms
            )
            if not stalled:
                return
            warned = self._commit_stall_warned
            self._commit_stall_warned = True
            pending = len(self._pending_commits)
        # count EVERY stalled tick (the log line stays once-per-episode):
        # a permanently wedged partition keeps the counter growing, which
        # is what the documented "sustained growth" alert watches
        _count_event(
            "raft_commit_stalls",
            "Ticks a leader spent with appends held uncommitted past the "
            "commit-latency watchdog threshold",
        )
        if warned:
            return
        _flight(
            "raft", "commit stall", node=self.node_id,
            term=self.persistent.term,
            commit=self.log.commit_position,
            oldest_pending=oldest[0], pending_futures=pending,
            match={m: p for m, p in self.match_position.items()},
        )
        from zeebe_tpu_torch.tracing.recorder import FLIGHT
        import logging

        logging.getLogger(__name__).warning(
            "raft %s: appends pending past %dms without commit "
            "(commit=%d, oldest pending position %d, %d futures); "
            "recent flight-recorder events:\n%s",
            self.node_id, self.config.commit_stall_ms,
            self.log.commit_position, oldest[0], pending,
            FLIGHT.format_slice(last=25),
        )

    # -- election: poll (pre-vote) then vote -------------------------------
    def _last_entry(self):
        pos = self.log.next_position - 1
        if pos < 0:
            return -1, -1
        return pos, self.log.term_at(pos)

    def _start_poll(self) -> None:
        """Reference RaftPollService: ask peers whether they would grant a
        vote for term+1 WITHOUT bumping terms; only a poll majority starts a
        real election."""
        self._reset_election_timer()
        others = self._other_members()
        if not others:
            # single-node partition: immediate self-election
            self._start_election()
            return
        self.polls = {self.node_id}
        last_position, last_term = self._last_entry()
        request = msgpack.pack(
            {
                "t": "poll",
                "term": self.persistent.term + 1,
                "candidate": self.node_id,
                "last_position": last_position,
                "last_term": last_term,
            }
        )
        for mid, addr in others.items():
            self._ask(addr, request, lambda msg, mid=mid: self._on_poll_response(mid, msg))

    def _on_poll_response(self, member_id: str, msg: Optional[dict]) -> None:
        if msg is None:
            self._note_peer_failure(member_id)
            return
        self._note_peer_ok(member_id)
        if self.state == RaftState.LEADER:
            return
        if msg.get("granted"):
            self.polls.add(msg.get("from", len(self.polls)))
            if len(self.polls) >= self._quorum():
                self.polls = set()
                self._start_election()

    def _start_election(self) -> None:
        _count_event("raft_elections_started")
        _flight(
            "raft", "election started", node=self.node_id,
            term=self.persistent.term + 1,
        )
        self._become(RaftState.CANDIDATE)
        self.persistent.term += 1
        self.persistent.voted_for = self.node_id
        self.persistent.save()
        self.leader_id = None
        self.votes = {self.node_id}
        self._reset_election_timer()
        if len(self.persistent.members) <= 1 or self._quorum() == 1:
            self._become_leader()
            return
        last_position, last_term = self._last_entry()
        request = msgpack.pack(
            {
                "t": "vote",
                "term": self.persistent.term,
                "candidate": self.node_id,
                "last_position": last_position,
                "last_term": last_term,
            }
        )
        for mid, addr in self._other_members().items():
            self._ask(addr, request, lambda msg, mid=mid: self._on_vote_response(mid, msg))

    def _on_vote_response(self, member_id: str, msg: Optional[dict]) -> None:
        if msg is None:
            self._note_peer_failure(member_id)
            return
        self._note_peer_ok(member_id)
        if self.state != RaftState.CANDIDATE:
            return
        if msg.get("term", 0) > self.persistent.term:
            self._step_down(msg["term"])
            return
        if msg.get("granted") and msg.get("term") == self.persistent.term:
            self.votes.add(member_id)
            if len(self.votes) >= self._quorum():
                self._become_leader()

    def _become_leader(self) -> None:
        _count_event("raft_elections_won")
        self.leader_id = self.node_id
        last, _ = self._last_entry()
        for mid in self._other_members():
            self.next_position[mid] = last + 1
            self.match_position[mid] = -1
        self.match_position[self.node_id] = last
        self._become(RaftState.LEADER)
        # initial event: commit an entry of the new term to establish
        # leadership over prior-term entries (reference
        # LeaderCommitInitialEvent; raft §5.4.2 no-op entry)
        from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
        from zeebe_tpu_torch.protocol.metadata import RecordMetadata
        from zeebe_tpu_torch.protocol.records import NoopRecord, Record

        initial = Record(
            metadata=RecordMetadata(
                record_type=RecordType.EVENT,
                value_type=ValueType.NOOP,
                intent=0,
            ),
            value=NoopRecord(),
        )
        initial.raft_term = self.persistent.term
        last = self.log.append([initial], commit=False)
        self.log.flush()
        self.match_position[self.node_id] = last
        self._maybe_commit()
        self._replicate_all()

    def _step_down(self, term: int) -> None:
        if term > self.persistent.term:
            _flight(
                "raft", "term bump", node=self.node_id,
                old_term=self.persistent.term, new_term=term,
            )
            self.persistent.term = term
            self.persistent.voted_for = None
            self.persistent.save()
        if self.state != RaftState.FOLLOWER:
            self._become(RaftState.FOLLOWER)
        self._reset_election_timer()

    # -- leader replication -------------------------------------------------
    def _replicate_all(self) -> None:
        if self._stopped:
            return
        for mid, addr in self._other_members().items():
            self._replicate_one(mid, addr)

    def _replicate_one(self, member_id: str, addr: RemoteAddress) -> None:
        if self._peer_backed_off(member_id):
            return  # unreachable peer: exponential backoff, not bare re-sends
        next_pos = self.next_position.get(member_id, 0)
        if next_pos < self.log.base_position:
            # the member is behind the compaction floor: the records it
            # needs are gone. It catches up out-of-band via snapshot
            # replication (SnapshotReplicationService analogue) and its
            # next append-response log_end hint fast-forwards next_position.
            self._ask(
                addr,
                msgpack.pack(
                    {
                        "t": "append",
                        "term": self.persistent.term,
                        "leader": self.node_id,
                        "prev_position": self.log.next_position - 1,
                        "prev_term": self.log.term_at(self.log.next_position - 1),
                        "commit": self.log.commit_position,
                        "frames": b"",
                        "snapshot_needed": True,
                    }
                ),
                lambda msg, mid=member_id: self._on_append_response(
                    mid, -1, msg
                ),
            )
            return
        prev_pos = next_pos - 1
        prev_term = self.log.term_at(prev_pos) if prev_pos >= 0 else -1
        # one locked slice + ONE codec pass for the whole replication
        # batch (was a per-record record_at lock + encode + bytes concat)
        batch = self.log.slice_records(
            next_pos, limit=self.config.replication_batch_records
        )
        buf, _offsets = codec.encode_records(batch)
        frames = bytes(buf)
        count = len(batch)
        request = msgpack.pack(
            {
                "t": "append",
                "term": self.persistent.term,
                "leader": self.node_id,
                "prev_position": prev_pos,
                "prev_term": prev_term,
                "commit": self.log.commit_position,
                "frames": frames,
            }
        )
        self._ask(
            addr,
            request,
            lambda msg, mid=member_id, sent=count, base=next_pos: self._on_append_response(
                mid, base + sent - 1, msg
            ),
        )

    def _on_append_response(
        self, member_id: str, last_sent: int, msg: Optional[dict]
    ) -> None:
        if msg is None:
            self._note_peer_failure(member_id)
            return
        self._note_peer_ok(member_id)
        if self.state != RaftState.LEADER:
            return
        term = msg.get("term", 0)
        if term > self.persistent.term:
            self._step_down(term)
            return
        if msg.get("success"):
            match = int(msg.get("match_position", -1))
            self.match_position[member_id] = max(
                self.match_position.get(member_id, -1), match
            )
            self.next_position[member_id] = self.match_position[member_id] + 1
            self._maybe_commit()
        else:
            # follower diverged: resume from ITS log end (skips the classic
            # one-at-a-time walk-back). The hint may also JUMP FORWARD —
            # a follower that installed a snapshot past our compaction
            # floor reports its fast-forwarded end, and replication must
            # resume there rather than stay pinned below the floor.
            # Clamp the forward jump to our own log end: a follower with a
            # longer stale-term uncommitted suffix reports a log_end past
            # anything we hold, and probing beyond our log would degrade
            # into a one-record-per-round walk-back.
            hint = int(msg.get("log_end", self.next_position.get(member_id, 1)))
            cur = self.next_position.get(member_id, 1)
            if hint > cur:
                self.next_position[member_id] = min(hint, self.log.next_position)
            else:
                self.next_position[member_id] = max(0, min(hint, cur - 1))

    def _maybe_commit(self) -> None:
        """Quorum commit (reference LeaderState.commit:171-199): sort match
        positions of all members, take the quorum-th highest — but never
        commit entries of a previous term (raft §5.4.2)."""
        positions = sorted(
            self.match_position.get(mid, -1) for mid in self.persistent.members
        )
        candidate = positions[len(positions) - self._quorum()]
        if candidate <= self.log.commit_position:
            return
        if self.log.term_at(candidate) != self.persistent.term:
            return
        self.log.set_commit_position(candidate)
        self._resolve_pending_commits()
        if (
            self._self_removal_position is not None
            and candidate >= self._self_removal_position
        ):
            # our own removal is committed: step aside now
            self._self_removal_position = None
            self._become(RaftState.FOLLOWER)

    # -- request handling (IO thread → actor hop) ---------------------------
    def _ask(self, addr: RemoteAddress, payload: bytes, callback) -> None:
        future = self.client.send_request(addr, payload)

        def on_complete(f: ActorFuture):
            msg = None
            if f._exception is None:
                try:
                    msg = msgpack.unpack(f._value)
                except Exception:  # noqa: BLE001
                    msg = None
            self.actor.run(lambda: callback(msg))

        future.on_complete(on_complete)

    def _on_request(self, payload: bytes):
        """IO thread: decode only; handlers run on the raft actor and the
        response future is completed there (the IO loop never blocks behind
        a slow append — heartbeats and votes keep flowing)."""
        try:
            msg = msgpack.unpack(payload)
        except Exception:  # noqa: BLE001
            return None
        t = msg.get("t")
        if t == "poll":
            return self.actor.call(lambda: self._handle_poll(msg))
        if t == "vote":
            return self.actor.call(lambda: self._handle_vote(msg))
        if t == "append":
            return self.actor.call(lambda: self._handle_append(msg))
        if t == "membership":
            return self.actor.call(lambda: self._handle_membership(msg))
        return None

    def _log_up_to_date(self, msg: dict) -> bool:
        last_position, last_term = self._last_entry()
        return (msg.get("last_term", -1), msg.get("last_position", -1)) >= (
            last_term,
            last_position,
        )

    def _handle_membership(self, msg: dict) -> bytes:
        """Forwarded membership op (reference RaftJoinService: the leader
        accepts joins; non-leaders answer with a redirect hint and the
        caller retries)."""
        if self.state != RaftState.LEADER:
            return msgpack.pack({"ok": False, "leader": self.leader_id})
        try:
            position = self._apply_membership_as_leader(
                {k: msg[k] for k in ("op", "member", "addr") if k in msg}
            )
        except Exception as e:  # noqa: BLE001
            return msgpack.pack({"ok": False, "error": str(e)})
        return msgpack.pack({"ok": True, "position": position})

    def _handle_poll(self, msg: dict) -> bytes:
        # inbound traffic proves the peer is back (a backed-off healed
        # follower times out and polls — without this, the leader would sit
        # out the rest of the backoff before resuming its appends)
        self._note_peer_ok(msg.get("candidate"))
        # A current leader never grants pre-votes: _last_heartbeat_ms is
        # only refreshed by incoming appends, which a leader does not
        # receive, so without this guard a rejoining up-to-date node could
        # poll-quorum a healthy leader into stepping aside (the exact churn
        # pre-vote exists to prevent — reference RaftPollService).
        granted = (
            self.state != RaftState.LEADER
            and msg.get("term", 0) > self.persistent.term
            and self._log_up_to_date(msg)
            and self.scheduler.now_ms() >= self._last_heartbeat_ms
            + self.config.election_timeout_ms
        )
        return msgpack.pack(
            {"granted": granted, "term": self.persistent.term, "from": self.node_id}
        )

    def _handle_vote(self, msg: dict) -> bytes:
        self._note_peer_ok(msg.get("candidate"))  # see _handle_poll
        term = msg.get("term", 0)
        if term > self.persistent.term:
            self._step_down(term)
        granted = (
            term == self.persistent.term
            and self.persistent.voted_for in (None, msg.get("candidate"))
            and self._log_up_to_date(msg)
        )
        if granted:
            self.persistent.voted_for = msg.get("candidate")
            self.persistent.save()
            self._reset_election_timer()
        return msgpack.pack(
            {"granted": granted, "term": self.persistent.term, "from": self.node_id}
        )

    def _handle_append(self, msg: dict) -> bytes:
        self._note_peer_ok(msg.get("leader"))  # see _handle_poll
        term = msg.get("term", 0)
        if term < self.persistent.term:
            return msgpack.pack(
                {"t": "append-rsp", "term": self.persistent.term, "success": False}
            )
        if term > self.persistent.term or self.state != RaftState.FOLLOWER:
            self._step_down(term)
        self.leader_id = msg.get("leader")
        self._last_heartbeat_ms = self.scheduler.now_ms()
        self._reset_election_timer()

        self.snapshot_needed = bool(msg.get("snapshot_needed", False))
        prev_position = int(msg.get("prev_position", -1))
        prev_term = int(msg.get("prev_term", -1))
        if prev_position >= 0:
            if prev_position >= self.log.next_position:
                return msgpack.pack(
                    {
                        "t": "append-rsp",
                        "term": self.persistent.term,
                        "success": False,
                        "log_end": self.log.next_position,
                    }
                )
            if prev_position >= self.log.base_position and (
                self.log.term_at(prev_position) != prev_term
            ):
                # conflicting suffix: truncate it (uncommitted by definition)
                self.log.truncate(prev_position)
                self._rollback_config(prev_position)
                self._fail_pending_from(
                    prev_position, "suffix truncated by new leader"
                )
                return msgpack.pack(
                    {
                        "t": "append-rsp",
                        "term": self.persistent.term,
                        "success": False,
                        "log_end": self.log.next_position,
                    }
                )

        frames = msg.get("frames", b"") or b""
        offset = 0
        records = []
        while offset < len(frames):
            record, offset = codec.decode_record(frames, offset)
            records.append(record)
        appended = False
        for record in records:
            if record.position < self.log.next_position:
                existing = self.log.record_at(record.position)
                if existing is None or existing.raft_term == record.raft_term:
                    continue  # duplicate delivery (or compacted-away)
                self.log.truncate(record.position)
                self._rollback_config(record.position)
                self._fail_pending_from(
                    record.position, "suffix truncated by new leader"
                )
            if record.position != self.log.next_position:
                return msgpack.pack(
                    {
                        "t": "append-rsp",
                        "term": self.persistent.term,
                        "success": False,
                        "log_end": self.log.next_position,
                    }
                )
            self.log.append_replicated(record)
            self._maybe_apply_config(record)
            appended = True
        if appended:
            self.log.flush()  # durable before acking (commit-is-final)

        commit = int(msg.get("commit", -1))
        if commit > self.log.commit_position:
            self.log.set_commit_position(min(commit, self.log.next_position - 1))
            # a deposed leader's surviving pending appends resolve here:
            # the new leader replicated them before the election, so they
            # committed — acked-means-committed holds across the flap
            self._resolve_pending_commits()
        return msgpack.pack(
            {
                "t": "append-rsp",
                "term": self.persistent.term,
                "success": True,
                "match_position": self.log.next_position - 1,
            }
        )
