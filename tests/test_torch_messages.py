"""Message correlation (the ``has_messages`` gate) in the zeebe_tpu_torch
step kernel and engine against zeebe_tpu's, bit for bit, on the CPU with
the kernels' plain versions, on start → receive task "paid" (correlation
key ``$.oid``) → end:

- CREATE waves walked round by round until every instance waits on its
  subscription (OPEN → OPENED), with numeric, string, bool, float (an
  incident) and absent (an incident) correlation keys;
- batches of message-partition commands: PUBLISH that correlates, stores
  (TTL), is dropped (no TTL), is rejected as a duplicate message id or on
  an occupied composite; DELETE of a stored message; CLOSE with the right
  and a wrong activity instance; OPEN of an occupied composite; a CORRELATE
  for an instance that is gone — then the walk on to the end;
- one composite opened and closed in one step, and one closed and opened:
  the subscription map ends the step exactly as the JAX kernel leaves it
  (the port defers the step's map deletes to one fused delete);
- the engine's message store: migrated to the device when a message
  workflow is deployed and back to the host when a host-only workflow
  joins it (a mixed deployment), and a snapshot with the store on the
  device restored across the engines.

Each round: state, emissions and stats equal; tolerance 0.
"""

import dataclasses
import itertools
import shutil

import numpy as np
import pytest

from test_torch_conditions import NUM_VARS, _state, walk
from test_torch_kernel import assert_step_equal, both_steps, jax_state_np
from test_tpu_parity import receive_task_process, record_signature
import zeebe_tpu.gateway.workers as jax_workers
import zeebe_tpu_torch.gateway.workers as port_workers
from zeebe_tpu.models.bpmn.builder import Bpmn as JBpmn
from zeebe_tpu.models.transform.transformer import transform_model as jtransform
from zeebe_tpu.tpu import batch as jb, graph as jg
from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
from zeebe_tpu_torch.protocol.intents import MessageIntent as MI
from zeebe_tpu_torch.protocol.intents import MessageSubscriptionIntent as MS
from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI
from zeebe_tpu_torch.protocol.intents import WorkflowInstanceSubscriptionIntent as WS
from zeebe_tpu_torch.tpu import batch as tb, graph as tg, hashmap
from zeebe_tpu_torch.tpu.conditions import VT_BOOL, VT_NUM, VT_STR

NOW = 1_000_000


@pytest.fixture(scope="module")
def receiving():
    workflows = jtransform(receive_task_process())
    for w in workflows:
        w.key, w.version = 9, 1
    jgraph, meta = jg.compile_graph(workflows)
    for name in ("oid", "paid"):
        meta.varspace.column(name)
    jgraph = dataclasses.replace(jgraph, num_vars=NUM_VARS)
    assert [g for g in tg.FEATURE_GATES if getattr(jgraph, g)] == ["has_messages"]
    return jgraph, meta


def _f32_bits(x):
    return int(np.float32(x).view(np.int32))


# the instances' correlation keys: (value type, number, string) of oid;
# VT 0 leaves oid out (the correlation-key incident), 1.5 is a float
KEYS = ([(VT_NUM, 100.0 + i, None) for i in range(4)]
        + [(VT_STR, 0.0, f"s-{i}") for i in range(4, 8)]
        + [(VT_BOOL, 1.0, None), (5, 1.5, None), (0, 0.0, None), (VT_NUM, 200.0, None)])


def _blank(size=32):
    return tb.batch_to_numpy(tb.empty(size, NUM_VARS, device="cpu"))


def _creates(meta):
    cols = _blank()
    oid = meta.varspace.column("oid")
    for i, (vt, num, text) in enumerate(KEYS):
        cols["valid"][i] = True
        cols["rtype"][i] = int(RecordType.COMMAND)
        cols["vtype"][i] = int(ValueType.WORKFLOW_INSTANCE)
        cols["intent"][i] = int(WI.CREATE)
        cols["wf"][i] = 0
        cols["v_vt"][i, oid] = vt
        cols["v_num"][i, oid] = num
        if text is not None:
            cols["v_str"][i, oid] = meta.interns.intern(text)
    return jb.RecordBatch(**cols)


def _corr(meta, key):
    """(value type, bits) of a correlation key as the kernel's OPEN carries
    it (the engine's sends turn every key into a string on the way)."""
    if isinstance(key, str):
        return VT_STR, meta.interns.intern(key)
    return (VT_BOOL if isinstance(key, bool) else VT_NUM), _f32_bits(float(key))


def _put_row(cols, i, vtype, intent, **fields):
    cols["valid"][i] = True
    cols["rtype"][i] = int(RecordType.COMMAND)
    cols["vtype"][i] = int(vtype)
    cols["intent"][i] = int(intent)
    for name, value in fields.items():
        cols[name][i] = value


def _publish(meta, cols, i, key, ttl=0, message_id="", paid=1.0):
    cvt, bits = _corr(meta, key)
    _put_row(cols, i, ValueType.MESSAGE, MI.PUBLISH, type_id=meta.interns.intern("paid"),
             retries=cvt, worker=bits, deadline=ttl,
             aux2_key=meta.interns.intern(message_id) if message_id else 0)
    paid_col = meta.varspace.column("paid")
    cols["v_vt"][i, paid_col] = VT_NUM
    cols["v_num"][i, paid_col] = paid


def _rows(emitted, vtype, intent, rtype=int(RecordType.COMMAND)):
    """Every emitted row of one kind, as {column: value} dicts in log order."""
    out = []
    for e in emitted:
        hit = np.nonzero(e["valid"] & (e["vtype"] == int(vtype)) & (e["rtype"] == rtype)
                         & (e["intent"] == int(intent)))[0]
        out += [{n: e[n][j] for n in tb.FIELDS} for j in hit]
    return out


def _copy_row(cols, i, row, **changes):
    for name in tb.FIELDS:
        cols[name][i] = row[name]
    for name, value in changes.items():
        cols[name][i] = value


def _count(emitted, vtype, intent, rtype=int(RecordType.EVENT)):
    return len(_rows(emitted, vtype, intent, rtype))


def _subscribed_instances(receiving):
    jgraph, meta = receiving
    jstate, emitted, over = walk(jgraph, _state(meta, 256), _creates(meta), 16, 40, now=NOW)
    assert over == 0
    return jstate, emitted


def test_subscribe_publish_store_delete_round_by_round(receiving):
    jgraph, meta = receiving
    jstate, emitted = _subscribed_instances(receiving)
    # 9 keys subscribe (numeric, string, bool); float and absent: incidents
    opens = _rows(emitted, ValueType.MESSAGE_SUBSCRIPTION, MS.OPEN)
    assert len(opens) == 10 and _count(emitted, ValueType.MESSAGE_SUBSCRIPTION, MS.OPENED) == 10
    incidents = _rows(emitted, ValueType.INCIDENT, 0)
    assert len(incidents) == 2 and {int(r["rej"]) for r in incidents} == {tb.ERR_CORRELATION_KEY}
    arrays = jax_state_np(jstate)
    assert (arrays["msub_ckey"] >= 0).sum() == 10

    cols = _blank()
    _publish(meta, cols, 0, 100)                       # correlates
    _publish(meta, cols, 1, "s-5", ttl=60_000)         # correlates and stores
    _publish(meta, cols, 2, "nobody", ttl=5_000, message_id="m-1")  # stores
    _publish(meta, cols, 3, "nobody-else")             # no TTL: DELETED
    _publish(meta, cols, 4, True)                      # the bool key
    close = opens[2]
    _copy_row(cols, 5, close, intent=int(MS.CLOSE), src=-1)          # closes
    _copy_row(cols, 6, opens[3], intent=int(MS.CLOSE), src=-1,
              aux_key=opens[3]["aux_key"] + 5)                       # wrong aik
    _copy_row(cols, 7, opens[4], src=-1)                             # occupied
    _put_row(cols, 8, ValueType.WORKFLOW_INSTANCE_SUBSCRIPTION, WS.CORRELATE,
             type_id=meta.interns.intern("paid"), retries=VT_NUM,
             worker=_f32_bits(7.0), aux_key=5 * 10**9 + 3, instance_key=7)  # gone
    j_out, t_out = both_steps(jgraph, arrays, jb.RecordBatch(**cols), NOW,
                              synthetic_workers=True)
    assert_step_equal(j_out, t_out)
    out = tb.batch_to_numpy(t_out[1])
    assert _count([out], ValueType.MESSAGE, MI.PUBLISHED) == 5
    assert _count([out], ValueType.MESSAGE, MI.DELETED) == 3  # the no-TTL ones
    assert _count([out], ValueType.MESSAGE_SUBSCRIPTION, MS.CLOSED) == 1
    rejected = _rows([out], ValueType.MESSAGE_SUBSCRIPTION, MS.OPEN,
                     int(RecordType.COMMAND_REJECTION))
    assert [int(r["rej"]) for r in rejected] == [tb.REJ_SUB_OCCUPIED]
    assert len(_rows([out], ValueType.WORKFLOW_INSTANCE_SUBSCRIPTION, WS.CORRELATE)) == 3
    arrays = jax_state_np(j_out[0])
    assert (arrays["msg_key"] >= 0).sum() == 2

    # a duplicate message id, a TTL publish on an occupied composite, and a
    # DELETE of the stored message by its key
    stored = _rows([out], ValueType.MESSAGE, MI.PUBLISHED, int(RecordType.EVENT))
    cols = _blank()
    _publish(meta, cols, 0, "nobody", ttl=5_000, message_id="m-1")   # duplicate id
    _publish(meta, cols, 1, "s-5", ttl=9_000)                       # occupied
    cvt, bits = _corr(meta, "nobody")
    _put_row(cols, 2, ValueType.MESSAGE, MI.DELETE, key=stored[2]["key"],
             type_id=meta.interns.intern("paid"), retries=cvt, worker=bits)
    j_out, t_out = both_steps(jgraph, arrays, jb.RecordBatch(**cols), NOW,
                              synthetic_workers=True)
    assert_step_equal(j_out, t_out)
    out = tb.batch_to_numpy(t_out[1])
    rejected = _rows([out], ValueType.MESSAGE, MI.PUBLISH, int(RecordType.COMMAND_REJECTION))
    assert sorted(int(r["rej"]) for r in rejected) == [tb.REJ_MSG_DUP,
                                                       tb.REJ_MSG_STORE_OCCUPIED]
    assert _count([out], ValueType.MESSAGE, MI.DELETED) == 1
    assert (jax_state_np(j_out[0])["msg_key"] >= 0).sum() == 1

    # the correlations run on to the end of their instances
    jstate, emitted, over = walk(jgraph, j_out[0], j_out[1], 16, 40, now=NOW)
    assert over == 0


@pytest.mark.parametrize("order", ["open_then_close", "close_then_open"])
def test_one_composite_opened_and_closed_in_one_step(receiving, order):
    """JAX inserts into the subscription map and then deletes from it; the
    port defers the delete to the step's one fused delete. A composite
    opened and closed in one step (absent before: the OPEN inserts, the
    CLOSE finds nothing) and one closed and opened (present: the CLOSE
    deletes, the OPEN is rejected) leave the map exactly as JAX does."""
    jgraph, meta = receiving
    jstate, emitted = _subscribed_instances(receiving)
    opens = _rows(emitted, ValueType.MESSAGE_SUBSCRIPTION, MS.OPEN)
    arrays = jax_state_np(jstate)
    present, absent = opens[0], dict(opens[1])
    absent["worker"] = _f32_bits(999.0)  # a composite nobody holds
    cols = _blank()
    row = 0
    for sub in (absent, present):
        pair = [(MS.OPEN, sub), (MS.CLOSE, sub)]
        if order == "close_then_open":
            pair.reverse()
        for intent, r in pair:
            _copy_row(cols, row, r, intent=int(intent), src=-1)
            row += 1
    j_out, t_out = both_steps(jgraph, arrays, jb.RecordBatch(**cols), NOW)
    assert_step_equal(j_out, t_out)
    after = jax_state_np(j_out[0])
    held = set(after["msub_map.keys"][after["msub_map.keys"] >= 0].tolist())
    ckey = [(int(r["type_id"]) << 35) | (int(r["retries"]) << 32)
            | (int(r["worker"]) & 0xFFFFFFFF) for r in (absent, present)]
    assert ckey[0] in held and ckey[1] not in held
    assert (after["msub_map.keys"] == hashmap.TOMBSTONE).sum() >= 1


# ---------------------------------------------------------------------------
# the engine's message store
# ---------------------------------------------------------------------------


@pytest.fixture
def engines():
    from test_torch_engine import JAX, PORT

    return JAX, PORT


@pytest.fixture(autouse=True)
def _subscriber_keys_from_one(monkeypatch):
    for workers in (jax_workers, port_workers):
        monkeypatch.setattr(workers, "_subscriber_keys", itertools.count(1))


def _collection_mi_process():
    builder = JBpmn.create_process("coll")
    sub = builder.start_event("s").sub_process(
        "each", multi_instance={"input_collection": "$.items", "input_element": "item"}
    )
    sub.start_event("ss").service_task("w", type="c-svc").end_event("se")
    return sub.embedded_done().end_event("e").done()


def _order_only():
    from test_tpu_parity import order_process

    return order_process()


def _migrations(ns, broker, sides):
    """Stored messages and subscriptions cross both ways: a TTL publish
    lands in the host store (no message workflow yet); deploying one moves
    the store to the device, where instances subscribe and publishes store
    and correlate; deploying a host-only workflow moves it back."""
    client = ns.gateway.ZeebeClient(broker)
    engine = broker.partitions[0].engine
    ns.deploy(client, _order_only())
    client.publish_message("paid", "early", {"n": 1}, time_to_live_ms=600_000)
    client.publish_message("paid", "7", {"n": 2}, time_to_live_ms=600_000)
    broker.run_until_idle()
    sides.append(engine._messages_on_device)
    ns.deploy(client, receive_task_process())
    broker.run_until_idle()
    sides.append(engine._messages_on_device)
    for oid in ("early", "w-1", "w-2", 8):
        client.create_instance("msgflow", {"oid": oid})
    client.publish_message("paid", "later", {"n": 3}, time_to_live_ms=600_000)
    broker.run_until_idle()
    ns.deploy(client, _collection_mi_process())
    broker.run_until_idle()
    sides.append(engine._messages_on_device)
    for key in ("w-1", "8", "7"):
        client.publish_message("paid", key, {"n": 4})
    client.create_instance("msgflow", {"oid": "later"})
    broker.run_until_idle()


def test_message_store_migrates_both_ways_like_the_jax_engine(tmp_path, engines):
    logs, sides = [], {}
    for ns in engines:
        clock = ns.runtime.ControlledClock(start_ms=1_000_000)
        broker = ns.broker(clock, str(tmp_path / ns.runtime.__name__))
        sides[ns.runtime.__name__] = []
        _migrations(ns, broker, sides[ns.runtime.__name__])
        logs.append(record_signature(broker.records(0)))
        engine = broker.partitions[0].engine
        # back on the host: the device tables are empty again
        assert int((np.asarray(engine.state.msub_ckey) >= 0).sum()) == 0
        assert int((np.asarray(engine.state.msg_key) >= 0).sum()) == 0
        assert sorted(m.correlation_key for m in engine._host.messages.values()) == [
            "7", "early", "later"]  # stored messages stay until their TTL
        broker.close()
    jax_log, port_log = logs
    for i, (a, b) in enumerate(zip(jax_log, port_log)):
        assert a == b, f"record {i} mismatch:\n  jax:  {a}\n  port: {b}"
    assert len(jax_log) == len(port_log)
    assert list(sides.values()) == [[False, True, False]] * 2
    completed = [s for s in port_log if s[2] == 5 and s[3] == 9 and s[8] == "msgflow"]
    assert len(completed) == 4  # early (stored), w-1, 8 (numeric) and later


@pytest.mark.parametrize("order", ["jax_snapshot_into_port", "port_snapshot_into_jax"])
def test_device_message_store_snapshot_restores_across_engines(tmp_path, engines, order):
    """Open subscriptions and stored messages on the device, snapshotted by
    one engine (FORMAT_DEVICE_V1) and reopened by the other: publishes then
    correlate as after reopening under the first engine."""
    jax_ns, port_ns = engines
    first, then = (jax_ns, port_ns) if order.startswith("jax") else (port_ns, jax_ns)
    src = tmp_path / "src"
    clock = first.runtime.ControlledClock(start_ms=1_000_000)
    broker = first.broker(clock, str(src))
    client = first.gateway.ZeebeClient(broker)
    first.deploy(client, receive_task_process())
    for i in range(6):
        client.create_instance("msgflow", {"oid": f"k-{i}" if i % 2 else i})
    client.publish_message("paid", "stored", {"n": 0}, time_to_live_ms=600_000)
    broker.run_until_idle()
    engine = broker.partitions[0].engine
    assert engine._messages_on_device
    assert int((np.asarray(engine.state.msub_ckey) >= 0).sum()) == 6
    broker.snapshot()
    broker.close()
    logs = []
    for ns in (first, then):
        copy = tmp_path / f"copy-{len(logs)}"
        shutil.copytree(src, copy)
        reopened = ns.broker(ns.runtime.ControlledClock(start_ms=1_000_000), str(copy))
        reopened.run_until_idle()
        c = ns.gateway.ZeebeClient(reopened)
        for key in ("k-1", "2", "k-5"):
            c.publish_message("paid", key, {"n": 1})
        c.create_instance("msgflow", {"oid": "stored"})
        reopened.run_until_idle()
        logs.append(record_signature(reopened.records(0)))
        if ns is port_ns:
            eng = reopened.partitions[0].engine
            assert eng._messages_on_device and eng.device_records_processed > 0
        reopened.close()
    own, crossed = logs
    assert crossed == own
    completed = [s for s in own if s[2] == 5 and s[3] == 9 and s[8] == "msgflow"]
    assert len(completed) == 4


def test_stage_corr_copies_the_jax_engines_bits():
    """The correlation columns of a numeric, string, bool and float key,
    and of an empty string (left unset), as both engines stage them."""
    from zeebe_tpu.tpu.engine import TpuPartitionEngine
    from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

    jax_engine = TpuPartitionEngine(0, 1, capacity=64)
    port_engine = CudaPartitionEngine(0, 1, capacity=64, device="cpu")
    keys = [42, "o-7", True, 1.5, "", -3, 2**40]
    got = {}
    for name, engine in (("jax", jax_engine), ("port", port_engine)):
        cols = {n: [0] * len(keys) for n in ("type_id", "retries", "worker")}
        for i, key in enumerate(keys):
            engine._stage_corr(cols, i, "paid", key)
        got[name] = cols
    assert got["jax"] == got["port"]
    assert got["port"]["worker"][0] == _f32_bits(42.0)
    assert got["port"]["retries"][4] == 0  # an empty string stages nothing

