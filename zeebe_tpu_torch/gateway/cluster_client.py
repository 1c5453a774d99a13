"""Cluster client: topology-aware command routing over the client API.

Reference parity: ``gateway/`` client impl — commands serialized to the
wire, routed to the current partition leader with NOT_LEADER retry +
topology refresh (``ClientTopologyManager`` + request retries), round-robin
partition selection for instance creation, and job workers receiving
push records down their own connection (``JobSubscriber`` with credits).
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from zeebe_tpu_torch.gateway.client import ClientException
from zeebe_tpu_torch.models.bpmn.model import BpmnModel
from zeebe_tpu_torch.models.bpmn.xml import write_model
from zeebe_tpu_torch.protocol import codec, msgpack
from zeebe_tpu_torch.protocol.enums import RecordType
from zeebe_tpu_torch.protocol.intents import (
    DeploymentIntent,
    JobIntent,
    MessageIntent,
    WorkflowInstanceIntent,
)
from zeebe_tpu_torch.protocol.metadata import RecordMetadata
from zeebe_tpu_torch.protocol.records import (
    DeploymentRecord,
    DeploymentResource,
    JobRecord,
    MessageRecord,
    Record,
    WorkflowInstanceRecord,
)
from zeebe_tpu_torch.transport import ClientTransport, RemoteAddress, TransportError

logger = logging.getLogger(__name__)

_subscriber_keys = itertools.count(1_000)


class _AdaptiveBackoff:
    """Poll pacing for leader-discovery/await loops: start at 1ms and
    double per miss up to ``cap``. The old fixed 50ms poll was both a
    measurable tax and a latency floor at sub-second end-to-end instance
    times; the 30ms default cap keeps the fast first probes while bounding
    the refresh_topology RPC load these loops generate during a leaderless
    window (each miss is a topology round trip — a 1-20ms steady rate
    from many client threads would hammer exactly the brokers trying to
    finish the election). ``reset()`` after any progress."""

    def __init__(self, base: float = 0.001, cap: float = 0.03):
        self.base = base
        self.cap = cap
        self._cur = base

    def sleep(self) -> None:
        time.sleep(self._cur)
        self._cur = min(self.cap, self._cur * 2)

    def reset(self) -> None:
        self._cur = self.base


class ClusterClient:
    """Client bound to a cluster via one or more bootstrap broker client
    addresses."""

    def __init__(
        self,
        contact_points: List[RemoteAddress],
        request_timeout_ms: int = 10_000,
        num_partitions: int = 1,
        retry_budget: int = 32,
    ):
        self.contact_points = list(contact_points)
        self.request_timeout_ms = request_timeout_ms
        self.num_partitions = num_partitions
        # per-command retry budget: leader changes and connection losses are
        # retried (with topology rediscovery) at most this many times inside
        # the request deadline — a permanently sick partition fails the
        # command with the retry history instead of spinning out the clock
        self.retry_budget = max(1, retry_budget)
        self.transport = ClientTransport(
            default_timeout_ms=request_timeout_ms,
            message_handler=self._on_push,
        )
        # partition id → leader client address
        self._leaders: Dict[int, RemoteAddress] = {}
        # partition id → the raft term of that leader, as the topology says
        self._leader_terms: Dict[int, int] = {}
        # command-id namespace for server-side retry dedup
        import uuid

        self._cid_prefix = uuid.uuid4().hex[:12]
        self._cid_counter = 0
        self._rr = itertools.count()
        self._push_handlers: Dict[int, Callable[[int, Record], None]] = {}
        self._lock = threading.Lock()
        # pushed records are dispatched off the transport IO thread: worker
        # handlers issue blocking requests (complete/fail) whose responses
        # arrive on that same IO loop (reference: JobSubscriber poll loop
        # runs on its own executor)
        import queue

        self._push_queue: "queue.Queue" = queue.Queue()
        self._push_thread = threading.Thread(
            target=self._push_dispatch_loop, name="zb-client-push", daemon=True
        )
        self._closing = False
        self._push_thread.start()

    # -- topology ----------------------------------------------------------
    def refresh_topology(self) -> Dict[int, RemoteAddress]:
        request = msgpack.pack({"t": "topology"})
        for addr in list(self._leaders.values()) + self.contact_points:
            try:
                payload = self.transport.send_request(addr, request, timeout_ms=2000).join(5)
                msg = msgpack.unpack(payload)
            except (TransportError, ValueError, TimeoutError):
                continue
            leaders, terms = {}, {}
            for pid, entry in msg.get("leaders", {}).items():
                a = entry.get("addr", ["", 0])
                leaders[int(pid)] = RemoteAddress(a[0], int(a[1]))
                terms[int(pid)] = int(entry.get("term", -1))
            if leaders:
                with self._lock:
                    self._leaders = leaders
                    self._leader_terms = terms
                return leaders
        return {}

    def _leader_for(self, partition: int) -> Optional[RemoteAddress]:
        with self._lock:
            addr = self._leaders.get(partition)
        if addr is None:
            self.refresh_topology()
            with self._lock:
                addr = self._leaders.get(partition)
        return addr

    def next_partition(self) -> int:
        return next(self._rr) % self.num_partitions

    # -- command plumbing --------------------------------------------------
    def send_command(
        self, partition: int, value, intent: int, key: int = -1
    ) -> Record:
        record = Record(
            key=key,
            metadata=RecordMetadata(
                record_type=RecordType.COMMAND,
                value_type=value.VALUE_TYPE,
                intent=int(intent),
            ),
            value=value,
        )
        # a stable command id across retries: the broker answers a
        # duplicate (retry after a slow/lost response) from the original
        # append instead of appending twice
        with self._lock:
            self._cid_counter += 1
            cid = f"{self._cid_prefix}:{self._cid_counter}"
        request = msgpack.pack(
            {
                "t": "command",
                "partition": partition,
                "cid": cid,
                "frame": codec.encode_record(record),
            }
        )
        # Overall budget vs per-attempt timeout: a single stalled attempt
        # must not consume the whole budget, or the loop never actually
        # retries after a timeout (the leader may be transiently slow —
        # cold jit compile, snapshotting — or freshly deposed; the retry
        # rediscovers topology). Reference: request retries in
        # gateway/.../impl/clustering/ClientTopologyManager.
        deadline = time.monotonic() + self.request_timeout_ms / 1000.0
        attempt_ms = max(1_000, self.request_timeout_ms // 4)
        last_error = "no leader known"
        failures = 0

        # the pause cap scales with the deadline so the budget genuinely
        # spans it (fast NOT_LEADER churn must not burn 32 retries while a
        # 60s-deadline caller's new leader is seconds away); floor 0.5s
        # keeps short-deadline clients responsive. The FIRST retry pauses
        # 5ms, not 50: a transiently-busy leader (drain in progress) is
        # usually back within milliseconds, and the serving path pays this
        # pause on every contended command.
        pause_cap = max(0.5, self.request_timeout_ms / 1000.0 / self.retry_budget)

        def pause():
            time.sleep(min(pause_cap, 0.005 * (1 << min(failures, 10))))

        leader_wait = _AdaptiveBackoff()
        while time.monotonic() < deadline and failures < self.retry_budget:
            addr = self._leader_for(partition)
            if addr is None:
                leader_wait.sleep()
                continue
            leader_wait.reset()
            remaining_ms = max(100, int((deadline - time.monotonic()) * 1000))
            timeout_ms = min(attempt_ms, remaining_ms)
            try:
                payload = self.transport.send_request(
                    addr, request, timeout_ms=timeout_ms
                ).join(timeout_ms / 1000.0 + 1)
                msg = msgpack.unpack(payload)
            except (TransportError, ValueError, TimeoutError) as e:
                # connection loss / timeout: burn one retry, rediscover the
                # leader, try again
                last_error = str(e)
                failures += 1
                with self._lock:
                    self._leaders.pop(partition, None)
                pause()
                continue
            if msg.get("t") == "command-rsp":
                response, _ = codec.decode_record(bytes(msg["frame"]))
                if response.metadata.record_type == RecordType.COMMAND_REJECTION:
                    raise ClientException(
                        response.metadata.rejection_type,
                        response.metadata.rejection_reason,
                    )
                return response
            if msg.get("t") == "error" and msg.get("code") == "NOT_LEADER":
                # leader change: burn one retry and follow the topology
                last_error = "NOT_LEADER"
                failures += 1
                with self._lock:
                    self._leaders.pop(partition, None)
                pause()
                continue
            if msg.get("t") == "error" and msg.get("code") == "RESOURCE_EXHAUSTED":
                # admission shed (broker overloaded or this connection's
                # in-flight bound hit): RETRYABLE by contract — back off
                # by the broker's hint and try again on the SAME leader
                # (shedding is load, not a leadership signal). Still burns
                # a retry so a permanently saturated broker fails the
                # command with history instead of spinning out the clock.
                last_error = f"RESOURCE_EXHAUSTED ({msg.get('reason', '')})"
                failures += 1
                retry_ms = max(1, int(msg.get("retry_ms", 50)))
                time.sleep(
                    min(pause_cap, retry_ms / 1000.0 * (1 << min(failures, 6)))
                )
                continue
            last_error = str(msg)
            failures += 1
            pause()
        raise TransportError(
            f"command failed after {failures} retries: {last_error}"
        )

    # -- topics (reference TopicClient.newCreateTopicCommand) --------------
    def create_topic(
        self, name: str, partitions: int = 1, replication_factor: int = 1
    ) -> Record:
        """Create a topic: the system partition assigns partition ids,
        orchestrates partition creation on the least-loaded brokers, and
        answers once every partition has a leader. The returned record's
        ``value.partition_ids`` are routable with ``partition_id=``."""
        from zeebe_tpu_torch.protocol.intents import TopicIntent
        from zeebe_tpu_torch.protocol.records import TopicRecord

        response = self.send_command(
            0,
            TopicRecord(
                name=name, partitions=partitions,
                replication_factor=replication_factor,
            ),
            TopicIntent.CREATE,
        )
        # widen round-robin routing over the new partitions
        self.num_partitions = max(
            self.num_partitions, max(response.value.partition_ids, default=0) + 1
        )
        return response

    # -- commands (reference WorkflowClient / JobClient / TopicClient) -----
    def deploy_model(self, model: BpmnModel, resource_name: str = "process.bpmn") -> Record:
        deployment = DeploymentRecord(
            resources=[
                DeploymentResource(resource=write_model(model), resource_name=resource_name)
            ]
        )
        return self.send_command(0, deployment, DeploymentIntent.CREATE)

    def create_instance(
        self,
        bpmn_process_id: str,
        payload: Optional[Dict[str, Any]] = None,
        partition_id: Optional[int] = None,
    ) -> Record:
        value = WorkflowInstanceRecord(
            bpmn_process_id=bpmn_process_id, payload=dict(payload or {})
        )
        pid = partition_id if partition_id is not None else self.next_partition()
        return self.send_command(pid, value, WorkflowInstanceIntent.CREATE)

    def cancel_instance(self, partition_id: int, workflow_instance_key: int) -> Record:
        value = WorkflowInstanceRecord(workflow_instance_key=workflow_instance_key)
        return self.send_command(
            partition_id, value, WorkflowInstanceIntent.CANCEL, key=workflow_instance_key
        )

    def update_payload(
        self,
        partition_id: int,
        workflow_instance_key: int,
        payload: Dict[str, Any],
        activity_instance_key: Optional[int] = None,
    ) -> Record:
        """Update the instance payload (same contract as the in-process
        client: for incident resolution pass the failed token's key as
        ``activity_instance_key`` — the reference client keys the command
        by the activity instance event)."""
        value = WorkflowInstanceRecord(
            workflow_instance_key=workflow_instance_key, payload=dict(payload)
        )
        return self.send_command(
            partition_id, value, WorkflowInstanceIntent.UPDATE_PAYLOAD,
            key=activity_instance_key if activity_instance_key is not None
            else workflow_instance_key,
        )

    def publish_message(
        self,
        name: str,
        correlation_key: str,
        payload: Optional[Dict[str, Any]] = None,
        time_to_live_ms: int = 0,
    ) -> Record:
        value = MessageRecord(
            name=name,
            correlation_key=correlation_key,
            time_to_live=time_to_live_ms,
            payload=dict(payload or {}),
        )
        # hash-routed to the message partition (engine routing contract)
        partition = _correlation_hash(correlation_key) % self.num_partitions
        return self.send_command(partition, value, MessageIntent.PUBLISH)

    def complete_job(self, partition_id: int, job_key: int, payload: Optional[dict] = None) -> Record:
        value = JobRecord(payload=dict(payload or {}))
        return self.send_command(partition_id, value, JobIntent.COMPLETE, key=job_key)

    def fail_job(self, partition_id: int, job_key: int, retries: int) -> Record:
        value = JobRecord(retries=retries)
        return self.send_command(partition_id, value, JobIntent.FAIL, key=job_key)

    def update_job_retries(self, partition_id: int, job_key: int, retries: int) -> Record:
        value = JobRecord(retries=retries)
        return self.send_command(
            partition_id, value, JobIntent.UPDATE_RETRIES, key=job_key
        )

    # -- job workers over the wire -----------------------------------------
    def _on_push(self, payload: bytes) -> None:
        # transport IO thread: decode + enqueue only
        try:
            msg = msgpack.unpack(payload)
        except ValueError:
            return
        if msg.get("t") != "pushed-record":
            return
        self._push_queue.put(msg)

    def _push_dispatch_loop(self) -> None:
        import queue

        while not self._closing:
            try:
                msg = self._push_queue.get(timeout=0.1)
            except queue.Empty:
                continue
            handler = self._push_handlers.get(int(msg.get("subscriber_key", -1)))
            if handler is None:
                continue
            try:
                record, _ = codec.decode_record(bytes(msg["frame"]))
                handler(
                    int(msg.get("partition", 0)), record,
                    int(msg.get("epoch", -1)),
                )
            except Exception:  # noqa: BLE001
                import traceback

                traceback.print_exc()

    def open_job_worker(
        self,
        job_type: str,
        handler: Callable[[int, Record], Optional[dict]],
        worker_name: str = "remote-worker",
        credits: int = 32,
        timeout_ms: int = 300_000,
        partitions: Optional[List[int]] = None,
    ) -> "RemoteJobWorker":
        return RemoteJobWorker(
            self, job_type, handler, worker_name, credits, timeout_ms,
            partitions if partitions is not None else list(range(self.num_partitions)),
        )

    def open_job_stream(
        self,
        job_type: str,
        worker_name: str = "stream-worker",
        credits: int = 32,
        timeout_ms: int = 300_000,
        partitions: Optional[List[int]] = None,
    ) -> "RemoteJobStream":
        """A push stream of ACTIVATED jobs WITHOUT auto-completion — the
        consumer completes/fails each job explicitly (the gateway's
        ActivateJobs RPC rides this; reference: an external worker over
        clients/go consumes the equivalent subscription)."""
        return RemoteJobStream(
            self, job_type, worker_name, credits, timeout_ms,
            partitions if partitions is not None else list(range(self.num_partitions)),
        )

    # -- workflow repository queries (reference newWorkflowRequest /
    # newResourceRequest served by the system partition leader) ------------
    def _repository_request(self, body: dict) -> dict:
        deadline = time.monotonic() + 10
        backoff = _AdaptiveBackoff()
        while time.monotonic() < deadline:
            addr = self._leader_for(0)
            if addr is None:
                backoff.sleep()
                continue
            try:
                rsp = msgpack.unpack(
                    self.transport.send_request(addr, msgpack.pack(body),
                                                timeout_ms=3000).join(4)
                )
            except (TransportError, ValueError, TimeoutError):
                with self._lock:
                    self._leaders.pop(0, None)
                backoff.sleep()
                continue
            if rsp.get("t") == "ok":
                return rsp
            if rsp.get("code") == "NOT_FOUND":
                raise ClientException(0, "workflow not found")
            backoff.sleep()
        raise TransportError("repository request failed")

    def list_workflows(self, bpmn_process_id: str = "") -> List[dict]:
        rsp = self._repository_request(
            {"t": "list-workflows", "process_id": bpmn_process_id}
        )
        return [
            {"bpmn_process_id": w["id"], "version": int(w["version"]),
             "workflow_key": int(w["key"])}
            for w in rsp.get("workflows", [])
        ]

    def get_workflow(self, workflow_key: int = -1, bpmn_process_id: str = "",
                     version: int = -1) -> dict:
        rsp = self._repository_request(
            {
                "t": "get-workflow",
                "workflow_key": workflow_key,
                "process_id": bpmn_process_id,
                "version": version,
            }
        )
        return {
            "bpmn_process_id": rsp["id"],
            "version": int(rsp["version"]),
            "workflow_key": int(rsp["key"]),
            "resource": bytes(rsp.get("resource", b"")),
            "resource_type": rsp.get("resource_type", "BPMN_XML"),
        }

    def open_topic_subscription(
        self,
        name: str,
        handler: Callable[[int, Record], None],
        partition_id: int = 0,
        start_position: Optional[int] = None,
        credits: int = 32,
        force_start: bool = False,
        ack_batch: int = 0,
    ) -> "RemoteTopicSubscriber":
        return RemoteTopicSubscriber(
            self, name, handler, partition_id, start_position, credits,
            force_start, ack_batch,
        )

    def close(self) -> None:
        self._closing = True
        self._push_thread.join(timeout=2)
        self.transport.close()


class _JobSubscriptionBase:
    """Shared job-subscription plumbing: subscribe on each partition
    leader, reopen on leader change, return credits robustly (owed
    credits retry from the monitor when the leader is transiently
    unknown), tear down on close. Subclasses deliver pushed jobs."""

    _MONITOR_NAME = "zb-jobsub-monitor"

    def __init__(self, client, job_type, worker_name, credits, timeout_ms,
                 partitions):
        self.client = client
        self.job_type = job_type
        self.worker_name = worker_name
        self.credits = credits
        self.timeout_ms = timeout_ms
        self.partitions = partitions
        self.subscriber_key = next(_subscriber_keys)
        self._subscribed_addr: Dict[int, RemoteAddress] = {}
        self._subscribed_term: Dict[int, Optional[int]] = {}
        self._owed_credits: Dict[int, int] = {}
        self._owed_lock = threading.Lock()
        self._closed = False
        client._push_handlers[self.subscriber_key] = self._on_record
        try:
            for pid in partitions:
                self._subscribe(pid)
        except Exception:
            # a partial open must not leak the push handler or the
            # already-opened partition subscriptions (their credits would
            # pull jobs into a handler nobody consumes)
            self._closed = True
            self._teardown_subscriptions()
            client._push_handlers.pop(self.subscriber_key, None)
            raise
        # reference: the client's subscription manager reopens subscriptions
        # when a partition's leader changes (topology listener); without
        # this a failover strands the worker on the old leader
        self._monitor = threading.Thread(
            target=self._monitor_leaders, name=self._MONITOR_NAME, daemon=True
        )
        self._monitor.start()

    # subclasses override
    def _on_record(self, partition: int, record: Record, epoch: int = -1) -> None:
        raise NotImplementedError

    def _monitor_leaders(self) -> None:
        while not self._closed and not self.client._closing:
            time.sleep(0.25)
            try:
                leaders = self.client.refresh_topology()
            except Exception:  # noqa: BLE001 - keep probing through outages
                continue
            for pid in self.partitions:
                addr = leaders.get(pid)
                if addr is None or self._closed:
                    continue
                # a broker re-elected at a higher term keeps its address
                # but installs a new engine, which holds no subscription
                with self.client._lock:
                    term = self.client._leader_terms.get(pid)
                if (
                    self._subscribed_addr.get(pid) != addr
                    or self._subscribed_term.get(pid) != term
                ):
                    try:
                        self._subscribe(pid)
                        # a fresh "add" resets the server-side credit
                        # budget — owed credits are covered
                        with self._owed_lock:
                            self._owed_credits.pop(pid, None)
                    except TransportError:
                        pass  # retried next tick
                else:
                    self._flush_owed(pid, addr)

    def _subscribe(self, partition: int) -> None:
        request = msgpack.pack(
            {
                "t": "job-subscription",
                "action": "add",
                "partition": partition,
                "subscriber_key": self.subscriber_key,
                "job_type": self.job_type,
                "worker": self.worker_name,
                "credits": self.credits,
                "timeout": self.timeout_ms,
            }
        )
        deadline = time.monotonic() + 10
        backoff = _AdaptiveBackoff()
        while time.monotonic() < deadline:
            addr = self.client._leader_for(partition)
            if addr is None:
                backoff.sleep()
                continue
            # the term is read before the request: an engine installed
            # after it shows a higher term, which the monitor resubscribes
            with self.client._lock:
                term = self.client._leader_terms.get(partition)
            try:
                payload = self.client.transport.send_request(
                    addr, request, timeout_ms=2000
                ).join(5)
                if msgpack.unpack(payload).get("t") == "ok":
                    self._subscribed_addr[partition] = addr
                    self._subscribed_term[partition] = term
                    return
            except (TransportError, ValueError, TimeoutError):
                pass
            with self.client._lock:
                self.client._leaders.pop(partition, None)
            backoff.sleep()
        raise TransportError(f"could not subscribe on partition {partition}")

    def _return_credit(self, partition: int, n: int = 1) -> None:
        """Return consumed credits; a transiently-unknown leader (or a
        failed send) OWES the credits, flushed by the monitor — silently
        dropping them starved the subscription one credit at a time."""
        addr = self.client._leader_for(partition)
        if addr is not None and self._send_credits(partition, addr, n):
            return
        with self._owed_lock:
            self._owed_credits[partition] = (
                self._owed_credits.get(partition, 0) + n
            )

    def _flush_owed(self, partition: int, addr: RemoteAddress) -> None:
        with self._owed_lock:
            owed = self._owed_credits.pop(partition, 0)
        if owed and not self._send_credits(partition, addr, owed):
            with self._owed_lock:
                self._owed_credits[partition] = (
                    self._owed_credits.get(partition, 0) + owed
                )

    def _send_credits(self, partition: int, addr: RemoteAddress, n: int) -> bool:
        try:
            payload = self.client.transport.send_request(
                addr,
                msgpack.pack(
                    {
                        "t": "job-subscription",
                        "action": "credits",
                        "partition": partition,
                        "subscriber_key": self.subscriber_key,
                        "credits": n,
                    }
                ),
                timeout_ms=2000,
            ).join(3)
            return msgpack.unpack(payload).get("t") == "ok"
        except (TransportError, ValueError, TimeoutError):
            return False

    def close(self) -> None:
        self._closed = True
        self.client._push_handlers.pop(self.subscriber_key, None)
        self._teardown_subscriptions()

    def _teardown_subscriptions(self) -> None:
        for pid, addr in list(self._subscribed_addr.items()):
            try:
                self.client.transport.send_request(
                    addr,
                    msgpack.pack(
                        {
                            "t": "job-subscription",
                            "action": "remove",
                            "partition": pid,
                            "subscriber_key": self.subscriber_key,
                        }
                    ),
                    timeout_ms=1000,
                )
            except TransportError:
                pass


class RemoteJobWorker(_JobSubscriptionBase):
    """Wire-level worker: subscribes on each partition leader, handles
    pushes, completes jobs, replenishes credits (reference JobSubscriber).

    Completions are PIPELINED: the handler runs inline on the push thread
    (preserving push order), but the COMPLETE/FAIL round trip + credit
    return run on a small pool. A synchronous per-push completion caps the
    whole serving path at 1/round-trip-latency per worker (~27 jobs/s at
    the measured 26ms commit round trip; profiled round 5) regardless of
    how fast the broker is — the reference's JobSubscriber likewise
    completes asynchronously on the client's event loop."""

    _MONITOR_NAME = "zb-worker-monitor"
    _COMPLETION_THREADS = 8

    def __init__(self, client, job_type, handler, worker_name, credits, timeout_ms, partitions):
        self.handler = handler
        self.handled: List[Record] = []
        # activations taken, (partition, job key, deadline) → whether the
        # completion reached a leader (None while it is on its way, or the
        # activation's second push, kept until it is known)
        self._taken: Dict[tuple, Any] = {}
        self._taken_lock = threading.Lock()
        import concurrent.futures

        self._completions = concurrent.futures.ThreadPoolExecutor(
            max_workers=self._COMPLETION_THREADS,
            thread_name_prefix="zb-worker-complete",
        )
        super().__init__(
            client, job_type, worker_name, credits, timeout_ms, partitions
        )

    def _on_record(self, partition: int, record: Record, epoch: int = -1) -> None:
        # one activation can be pushed twice: a leader that steps down
        # pushes the job before its ACTIVATED event commits, and the next
        # leader, processing the same ACTIVATE command, pushes it again
        # with the same deadline. It is handled once: a second push that
        # comes while the first completion is on its way is kept, and
        # handled only if that completion never reaches a leader
        taken = (partition, record.key, record.value.deadline)
        with self._taken_lock:
            state = self._taken.get(taken, False)
            if state is not False:
                if state is None:
                    self._taken[taken] = record
                return
            self._taken[taken] = None
            while len(self._taken) > 4096:
                self._taken.pop(next(iter(self._taken)))
        self.handled.append(record)
        try:
            result = self.handler(partition, record)
            failed = False
        except Exception:  # noqa: BLE001 - handler errors fail the job
            result, failed = None, True
        try:
            self._completions.submit(
                self._finish, partition, record, result, failed
            )
        except RuntimeError:  # pool shut down mid-push: finish inline
            self._finish(partition, record, result, failed)

    def _finish(self, partition: int, record: Record, result, failed: bool) -> None:
        reached = True
        try:
            if failed:
                try:
                    self.client.fail_job(
                        partition, record.key, record.value.retries - 1
                    )
                except ClientException:
                    pass  # job already final
                except (TransportError, TimeoutError):
                    reached = False  # broker unreachable
                return
            try:
                self.client.complete_job(
                    partition, record.key,
                    result if isinstance(result, dict) else None,
                )
            except ClientException:
                # at-least-once delivery: a failover can re-push a job
                # whose COMPLETE already committed — the rejection is
                # expected and must not break the worker (reference
                # JobSubscriber tolerates completion rejections the same
                # way)
                pass
            except (TransportError, TimeoutError):
                # broker unreachable: the job times out server-side and
                # re-activates; this worker keeps its credit flowing
                reached = False
        finally:
            taken = (partition, record.key, record.value.deadline)
            with self._taken_lock:
                again = self._taken.get(taken)
                if taken in self._taken:
                    self._taken[taken] = reached
            self._return_credit(partition)
            if not reached and isinstance(again, Record):
                self._on_record(partition, again)

    def close(self) -> None:
        super().close()
        self._completions.shutdown(wait=False)


def _correlation_hash(key: str) -> int:
    from zeebe_tpu_torch.engine.interpreter import _correlation_hash as impl

    return impl(key)


class RemoteTopicSubscriber:
    """Wire-level topic subscription (reference SubscriberGroup): receives
    pushed records down its own connection, auto-acks in batches, and
    reopens on the new leader after a failover — resuming from the ack
    position persisted in the partition log."""

    def __init__(self, client, name, handler, partition_id, start_position,
                 credits, force_start, ack_batch):
        self.client = client
        self.name = name
        self.handler = handler
        self.partition_id = partition_id
        self.start_position = start_position
        self.credits = credits
        self.subscriber_key = next(_subscriber_keys)
        self.records: List[Record] = []
        self._ack_batch = ack_batch or max(credits // 2, 1)
        self._since_ack = 0
        self._subscribed_addr: Optional[RemoteAddress] = None
        # subscription epoch: bumped on every (re)open; pushes echo it so
        # in-flight records from a superseded pusher (old leader, old
        # connection) can never interleave with the new stream — the
        # round-4 failover flake was exactly two pushers' TCP streams
        # arriving out of order
        self._epoch = 0
        self._closed = False
        client._push_handlers[self.subscriber_key] = self._on_record
        self._open(force_start=force_start)
        self._monitor = threading.Thread(
            target=self._monitor_leader, name="zb-topic-sub-monitor", daemon=True
        )
        self._monitor.start()

    def _request(self, body: dict, timeout_s: float = 5.0) -> bool:
        addr = self.client._leader_for(self.partition_id)
        if addr is None:
            return False
        try:
            payload = self.client.transport.send_request(
                addr, msgpack.pack(body), timeout_ms=int(timeout_s * 1000)
            ).join(timeout_s + 1)
            if msgpack.unpack(payload).get("t") == "ok":
                self._subscribed_addr = addr
                return True
        except (TransportError, ValueError, TimeoutError):
            pass
        with self.client._lock:
            self.client._leaders.pop(self.partition_id, None)
        return False

    def _open(self, force_start: bool = False) -> None:
        deadline = time.monotonic() + 10
        # optimistic epoch bump (the new pusher's records may arrive
        # before the open response) with ROLLBACK on failure: a failed
        # reopen attempt against an unchanged leader must not deafen the
        # still-live old-epoch pusher
        prev_epoch = self._epoch
        self._epoch = prev_epoch + 1
        body = {
            "t": "topic-subscription",
            "action": "open",
            "partition": self.partition_id,
            "subscriber_key": self.subscriber_key,
            "name": self.name,
            "start_position": -1 if self.start_position is None else self.start_position,
            "credits": self.credits,
            "force_start": force_start,
            "epoch": self._epoch,
        }
        backoff = _AdaptiveBackoff()
        while time.monotonic() < deadline and not self._closed:
            if self._request(body):
                return
            backoff.sleep()
        self._epoch = prev_epoch
        if not self._closed:
            raise TransportError(f"could not open topic subscription {self.name!r}")

    def _monitor_leader(self) -> None:
        # reference: the client subscription manager reopens subscriptions on
        # partition leader change; resumption point comes from logged acks
        while not self._closed and not self.client._closing:
            time.sleep(0.25)
            try:
                leaders = self.client.refresh_topology()
            except Exception:  # noqa: BLE001
                continue
            addr = leaders.get(self.partition_id)
            if addr is None or self._closed:
                continue
            if addr != self._subscribed_addr:
                logger.debug(
                    "topic sub %r: leader %s != subscribed %s, reopening",
                    self.name, addr, self._subscribed_addr,
                )
                try:
                    self._open()
                except TransportError:
                    logger.debug("topic sub %r: reopen failed", self.name)
                continue
            # same leader address: verify the pusher survived leadership
            # churn (pushers are leader-local server-side; a flap through
            # the SAME broker clears them without an address change) and
            # that it carries OUR epoch (a lost open response leaves the
            # server one epoch ahead)
            if not self._check_alive(addr):
                logger.debug(
                    "topic sub %r: pusher lost on %s, reopening",
                    self.name, addr,
                )
                try:
                    self._open()
                except TransportError:
                    logger.debug("topic sub %r: reopen failed", self.name)

    def _check_alive(self, addr: RemoteAddress) -> bool:
        try:
            payload = self.client.transport.send_request(
                addr,
                msgpack.pack({
                    "t": "topic-subscription",
                    "action": "check",
                    "partition": self.partition_id,
                    "subscriber_key": self.subscriber_key,
                    "name": self.name,
                }),
                timeout_ms=2000,
            ).join(3)
            rsp = msgpack.unpack(payload)
        except (TransportError, ValueError, TimeoutError):
            return True  # inconclusive: don't churn the subscription
        if rsp.get("t") != "ok":
            return True  # e.g. NOT_LEADER mid-transition: topology follows
        return bool(rsp.get("known")) and int(rsp.get("epoch", -1)) == self._epoch

    def _on_record(self, partition_id: int, record: Record, epoch: int = -1) -> None:
        if 0 <= epoch != self._epoch:
            return  # superseded pusher's in-flight tail
        self.records.append(record)
        if self.handler is not None:
            self.handler(partition_id, record)
        self._since_ack += 1
        if self._since_ack >= self._ack_batch:
            self.ack(record.position)

    def ack(self, position: int) -> None:
        self._since_ack = 0
        self._request(
            {
                "t": "topic-subscription",
                "action": "ack",
                "partition": self.partition_id,
                "subscriber_key": self.subscriber_key,
                "name": self.name,
                "position": position,
            },
            timeout_s=2.0,
        )

    def close(self) -> None:
        self._closed = True
        self.client._push_handlers.pop(self.subscriber_key, None)
        self._request(
            {
                "t": "topic-subscription",
                "action": "close",
                "partition": self.partition_id,
                "subscriber_key": self.subscriber_key,
                "name": self.name,
            },
            timeout_s=1.0,
        )


class RemoteJobStream(_JobSubscriptionBase):
    """Wire-level job stream: subscribes on each partition leader and
    queues activated-job pushes for explicit consumption — no automatic
    completion (``RemoteJobWorker`` is the auto-completing variant). One
    credit returns per consumed job; the broker's in-flight bound is
    ``credits``. Reopens on leader change like the worker."""

    _MONITOR_NAME = "zb-stream-monitor"

    def __init__(self, client, job_type, worker_name, credits, timeout_ms,
                 partitions):
        import queue as _queue

        self.jobs: "_queue.Queue" = _queue.Queue()
        super().__init__(
            client, job_type, worker_name, credits, timeout_ms, partitions
        )

    def _on_record(self, partition: int, record: Record, epoch: int = -1) -> None:
        self.jobs.put((partition, record))

    def take(self, timeout: Optional[float] = None):
        """Next (partition, job record), or None on timeout. Returns one
        credit to the partition (the consumer now owns the in-flight
        job)."""
        import queue as _queue

        try:
            partition, record = self.jobs.get(timeout=timeout)
        except _queue.Empty:
            return None
        self._return_credit(partition)
        return partition, record
