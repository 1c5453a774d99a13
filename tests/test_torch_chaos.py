"""One fixed-seed chaos leg of ``tests/test_chaos.py`` on the port's stack.

Three port ``ClusterBroker``s behind the port's copy of the seeded
``FaultPlane`` (network jitter), every partition served by
``CudaPartitionEngine`` on the CPU, hold the four invariants of
``docs/CHAOS.md`` through a torn snapshot commit and two leader crashes:

1. every acknowledged append survives, identically on every live replica;
2. at most one raft leader per term;
3. replaying the surviving committed log through the host oracle is
   deterministic and reconstructs the live CUDA engine's jobs, element
   instances and processed position (read from its device tables);
4. a crash between the snapshot commit's two renames is salvaged at
   restart, and the salvaged node, elected leader, serves on.
"""

import collections

from test_chaos import SEED
from test_cluster import wait_until

from zeebe_tpu_torch.cluster import RaftState
from zeebe_tpu_torch.log import stateser
from zeebe_tpu_torch.models.bpmn.builder import Bpmn
from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent
from zeebe_tpu_torch.runtime.config import BrokerCfg
from zeebe_tpu_torch.runtime.engines import engine_factory_from_config
from zeebe_tpu_torch.runtime.metrics import event_count
from zeebe_tpu_torch.testing.chaos import (
    ChaosHarness,
    DiskFaults,
    FaultPlane,
    invariant,
    oracle_state_bytes,
    replay_oracle,
)
from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine
from zeebe_tpu_torch.tpu.state import JB_STATE


def _process():
    builder = Bpmn.create_process("order-process").start_event("start")
    builder = builder.service_task("collect-money", type="payment-service")
    return builder.service_task("audit", type="audit-service").end_event("end").done()


def _cuda_factory():
    cfg = BrokerCfg()
    cfg.engine.type = "cuda"
    return engine_factory_from_config(cfg, device="cpu")


def _device_jobs(engine):
    s = engine.state
    live = s.job_state >= 0
    return dict(zip(s.job_key[live].tolist(), s.job_i32[live, JB_STATE].tolist()))


def _device_instances(engine):
    s = engine.state
    return sorted(s.ei_key[s.ei_state >= 0].tolist())


def _identity(r):
    """What a replica stores of a record and no engine rewrites (a
    leader's log hands back the records its engine processed)."""
    md = r.metadata
    return (r.position, r.raft_term, r.timestamp, int(md.record_type),
            int(md.value_type), int(md.intent), r.key, r.source_record_position,
            md.request_id)


def _settled_leader(harness):
    """The leader's committed log and CUDA engine once the log is drained
    and quiescent (test_chaos._assert_oracle_parity's settle loop)."""
    import time

    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        leader = harness.leader_of(0)
        if leader is None:
            time.sleep(0.2)
            continue
        server = leader.partitions[0]
        before = server.log.commit_position
        time.sleep(0.6)
        engine = server.engine
        if engine is None or server.log.commit_position != before:
            continue
        committed = server.log.reader(0).read_committed()
        if committed and committed[-1].position == engine.last_processed_position:
            return committed, engine
    raise AssertionError("the leader never settled")


def test_chaos_leg_on_the_cuda_engine(tmp_path):
    plane = FaultPlane(seed=SEED)
    plane.set_rule(delay_ms=0, delay_jitter_ms=3)
    harness = ChaosHarness(str(tmp_path), n_brokers=3, plane=plane,
                           engine_factory=_cuda_factory())
    leaders = []

    def watch(node):
        raft = harness.brokers[node].partitions[0].raft
        raft.on_state_change(
            lambda state, term, nid=raft.node_id:
            leaders.append((nid, term)) if state == RaftState.LEADER else None)

    for node in harness.brokers:
        watch(node)
    client = None
    try:
        harness.await_leaders()
        client = harness.client(request_timeout_ms=30_000)
        client.deploy_model(_process())
        paid = []
        worker = client.open_job_worker(
            "payment-service", lambda pid, rec: paid.append(rec.key) or {"paid": True})
        acked = [client.create_instance("order-process", {"orderId": i}) for i in range(4)]
        assert wait_until(lambda: len(paid) >= 4, 30), paid

        # invariant 4's fault: the leader's snapshot rewrite crashes between
        # its two renames, then the leader itself crash-stops
        first = harness.leader_of(0)
        first.snapshot_all()
        server = first.partitions[0]
        meta = server.snapshots.storage.list()[0]
        DiskFaults.crash_snapshot_commit(
            server.snapshots.storage, meta, stateser.encode_state({"torn": True}),
            DiskFaults.CRASH_OLD_ASIDE)
        harness.crash(first.node_id)
        assert wait_until(lambda: harness.leader_of(0) is not None, 30)
        acked.append(client.create_instance("order-process", {"orderId": 4}))
        assert wait_until(lambda: len(paid) >= 5, 30), paid

        salvaged = event_count("snapshot_salvage_events")
        harness.restart(first.node_id)
        watch(first.node_id)
        assert event_count("snapshot_salvage_events") - salvaged >= 2
        # the successor crash-stops too: the salvaged node is one of the two
        # left, and whichever leads restores its engine and serves on
        second = harness.leader_of(0)
        harness.crash(second.node_id)
        assert wait_until(lambda: harness.leader_of(0) is not None, 60)
        acked.append(client.create_instance("order-process", {"orderId": 5}))
        assert wait_until(lambda: len(paid) >= 6, 30), paid
        worker.close()

        # the settled leader may have been elected after the last instance,
        # restoring every record from the snapshot: its tables, not its
        # processed count, are what invariant 3 reads
        committed, live = _settled_leader(harness)
        assert isinstance(live, CudaPartitionEngine)

        # invariant 1: the acknowledged CREATEs are in the log, and the live
        # replicas' committed logs agree record for record
        created = {r.key for r in committed
                   if r.metadata.value_type == ValueType.WORKFLOW_INSTANCE
                   and r.metadata.record_type == RecordType.EVENT
                   and r.metadata.intent == WorkflowInstanceIntent.CREATED}
        for response in acked:
            invariant(response.value.workflow_instance_key in created,
                      "invariant 1: an acknowledged instance was lost")
        logs = [b.partitions[0].log for n, b in harness.brokers.items()
                if n not in harness.crashed]
        common = min(log.commit_position for log in logs)
        encoded = [[_identity(r) for r in log.reader(0).read_committed()
                    if r.position <= common] for log in logs]
        invariant(encoded[0] and all(e == encoded[0] for e in encoded[1:]),
                  "invariant 1: live replicas' committed logs diverged")

        # invariant 2
        by_term = collections.defaultdict(set)
        for node, term in leaders:
            by_term[term].add(node)
        invariant(len(by_term) >= 3 and all(len(n) == 1 for n in by_term.values()),
                  f"invariant 2: leaders by term {dict(by_term)}")

        # invariant 3 against the device tables: six instances wait on
        # their audit job, so jobs and instances are live on both sides
        oracle_a, oracle_b = replay_oracle(committed), replay_oracle(committed)
        invariant(oracle_state_bytes(oracle_a) == oracle_state_bytes(oracle_b),
                  "invariant 3: independent oracle replays diverged bit-for-bit")
        want_jobs = {k: j.state for k, j in oracle_a.jobs.items()}
        invariant(len(want_jobs) == 6 and _device_jobs(live) == want_jobs,
                  "invariant 3: jobs diverged between replay and the CUDA engine")
        invariant(sorted(oracle_a.element_instances.instances) == _device_instances(live),
                  "invariant 3: element instances diverged between replay and "
                  "the CUDA engine")
        invariant(oracle_a.last_processed_position == live.last_processed_position,
                  "invariant 3: processed position diverged")
    finally:
        if client is not None:
            client.close()
        harness.close()
