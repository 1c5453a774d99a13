"""Boundary events (the ``has_boundaries`` gate) and ``tick_kernel`` in the
zeebe_tpu_torch step kernel against zeebe_tpu's, bit for bit, on the CPU
with the kernels' plain versions:

- BASELINE config 4 (``bench.build_graph_c4``: a receive task with an
  interrupting 30 s timer boundary) at ``run_device_config_c4``'s phases:
  CREATE, PUBLISH for the even half, ``tick_kernel`` 31 s later, each
  walked round by round to the end;
- a timer boundary on a service task, interrupting and not, fired while
  the job is out (TERMINATE_JOB_TASK: the job map probe, the job CANCEL),
  and a receive task with a message AND a timer boundary (the disarm's and
  TERMINATE_CATCH_EVENT's timer scans, a timer cancelled twice);
- ``tick_kernel`` on a state of random due and not-due timers and jobs;
- the port's armed-timer scan (a sort and a binary search) against the
  JAX kernel's dense [B, T] form.

Each round: state, emissions and stats equal; tolerance 0.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from test_torch_conditions import NUM_VARS, _state, walk
from test_torch_kernel import _assert_leaf, jax_state_np
from test_tpu_parity import boundary_timer_process, dual_boundary_process
from zeebe_tpu.models.transform.transformer import transform_model as jtransform
from zeebe_tpu.tpu import batch as jb, graph as jg, kernel as jk, state as js
from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
from zeebe_tpu_torch.protocol.intents import JobIntent as JI
from zeebe_tpu_torch.protocol.intents import MessageIntent as MI
from zeebe_tpu_torch.protocol.intents import TimerIntent as TI
from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI
from zeebe_tpu_torch.tpu import batch as tb, graph as tg, kernel as tk, state as ts
from zeebe_tpu_torch.tpu.conditions import VT_STR

NOW = 1_000_000


def _rows(emitted, vtype, intent, rtype=int(RecordType.EVENT)):
    return sum(int((e["valid"] & (e["vtype"] == int(vtype)) & (e["rtype"] == rtype)
                    & (e["intent"] == int(intent))).sum()) for e in emitted)


def _roots_completed(emitted):
    return sum(int((e["valid"] & (e["vtype"] == int(ValueType.WORKFLOW_INSTANCE))
                    & (e["intent"] == int(WI.ELEMENT_COMPLETED)) & (e["elem"] == 0)).sum())
               for e in emitted)


def assert_tick_equal(jstate, now):
    """Both packages' tick on one state: equal batches and counts. Returns
    the JAX batch (the TRIGGER / TIME_OUT commands to walk on)."""
    j_out, j_count = jk.tick_kernel(jstate, jnp.asarray(now, jnp.int64))
    t_out, t_count = tk.tick_kernel(
        ts.state_from_numpy(jax_state_np(jstate), device="cpu"), now)
    _assert_leaf("count", t_count.numpy(), j_count)
    for name in tb.FIELDS:
        _assert_leaf(name, getattr(t_out, name).numpy(), getattr(j_out, name))
    return j_out, int(j_count)


def test_config4_create_publish_tick_round_by_round():
    """run_device_config_c4's wave at a width of 32: the even half
    correlates, the odd half expires through the interrupting boundary."""
    jgraph, meta = bench.build_graph_c4()
    meta.varspace.column("paid")
    jgraph = dataclasses.replace(jgraph, num_vars=NUM_VARS)
    assert [g for g in tg.FEATURE_GATES if getattr(jgraph, g)] == [
        "has_timers", "has_messages", "has_boundaries"]
    wave = 32
    jstate = js.make_state(capacity=4 * wave, num_vars=NUM_VARS, job_capacity=4 * wave,
                           timer_capacity=2 * wave, msub_capacity=2 * wave,
                           msg_capacity=wave)
    jstate, created, over = walk(jgraph, jstate, bench.stage_c4_creates(
        meta, wave, NUM_VARS, 0), wave, 40, now=0)
    assert _rows(created, ValueType.TIMER, TI.CREATED) == wave
    jstate, published, over2 = walk(jgraph, jstate, bench.stage_c4_publishes(
        meta, wave, NUM_VARS, 0), wave, 40, now=0)
    assert _rows(published, ValueType.TIMER, TI.CANCELED) == wave // 2
    trig, count = assert_tick_equal(jstate, 31_000)
    assert count == wave // 2
    jstate, fired, over3 = walk(jgraph, jstate, trig, wave, 40, now=31_000)
    assert over == over2 == over3 == 0
    assert _roots_completed(published) + _roots_completed(fired) == wave
    assert _rows(fired, ValueType.WORKFLOW_INSTANCE, WI.BOUNDARY_EVENT_OCCURRED) == wave // 2
    arrays = jax_state_np(jstate)
    assert (arrays["timer_key"] >= 0).sum() == 0 and (arrays["msub_ckey"] >= 0).sum() == 0


def _compiled(model):
    workflows = jtransform(model)
    for w in workflows:
        w.key, w.version = 9, 1
    jgraph, meta = jg.compile_graph(workflows)
    for name in ("orderId", "cid"):
        meta.varspace.column(name)
    return dataclasses.replace(jgraph, num_vars=NUM_VARS), meta


def _creates(meta, n, var, strings=False):
    cols = tb.batch_to_numpy(tb.empty(n, NUM_VARS, device="cpu"))
    col = meta.varspace.column(var)
    cols["valid"][:] = True
    cols["rtype"][:] = int(RecordType.COMMAND)
    cols["vtype"][:] = int(ValueType.WORKFLOW_INSTANCE)
    cols["intent"][:] = int(WI.CREATE)
    cols["wf"][:] = 0
    if strings:
        cols["v_vt"][:, col] = VT_STR
        cols["v_str"][:, col] = [meta.interns.intern(f"c-{i}") for i in range(n)]
    else:
        cols["v_vt"][:, col] = 3
        cols["v_num"][:, col] = np.arange(n)
    return jb.RecordBatch(**cols)


def _workers(meta, *types):
    """A state whose job subscriptions take ``types``, one each."""
    st = js.make_state(capacity=256, num_vars=NUM_VARS, sub_capacity=8)
    n = len(types)
    return dataclasses.replace(
        st,
        sub_key=st.sub_key.at[:n].set(jnp.arange(1, n + 1)),
        sub_type=st.sub_type.at[:n].set(
            jnp.asarray([meta.interns.intern(t) for t in types], jnp.int32)),
        sub_worker=st.sub_worker.at[:n].set(meta.interns.intern("bench-worker")),
        sub_credits=st.sub_credits.at[:n].set(2**31 - 1),
        sub_timeout=st.sub_timeout.at[:n].set(300_000),
        sub_valid=st.sub_valid.at[:n].set(True),
    )


def _hold_jobs(cols):
    """Drop the synthetic workers' COMPLETE commands: the jobs stay out."""
    done = (cols["valid"] & (cols["vtype"] == int(ValueType.JOB))
            & (cols["rtype"] == int(RecordType.COMMAND))
            & (cols["intent"] == int(JI.COMPLETE)))
    cols["valid"] &= ~done


@pytest.mark.parametrize("interrupting", [True, False], ids=["interrupting", "non_interrupting"])
def test_timer_boundary_fires_while_the_job_is_out(interrupting):
    jgraph, meta = _compiled(boundary_timer_process(interrupting=interrupting))
    assert jgraph.has_boundaries and jgraph.has_timers and not jgraph.has_messages
    n = 12
    jstate, created, over = walk(jgraph, _workers(meta, "slow-service", "esc-service"),
                                 _creates(meta, n, "orderId"), 8, 60, edit=_hold_jobs,
                                 now=NOW)
    assert _rows(created, ValueType.JOB, JI.ACTIVATED) == n
    # the rebuild puts the jobs into the job map, which the job CANCEL's
    # type comes through
    jstate = js.rebuild_lookup_state(jstate)
    trig, count = assert_tick_equal(jstate, NOW + 31_000)
    assert count == n
    jstate, fired, over2 = walk(jgraph, jstate, trig, 8, 80, now=NOW + 31_000)
    assert over == over2 == 0
    assert _rows(fired, ValueType.WORKFLOW_INSTANCE, WI.BOUNDARY_EVENT_OCCURRED) == n
    slow = meta.interns.intern("slow-service")
    cancels = sum(int((e["valid"] & (e["vtype"] == int(ValueType.JOB))
                       & (e["rtype"] == int(RecordType.COMMAND))
                       & (e["intent"] == int(JI.CANCEL)) & (e["type_id"] == slow)).sum())
                  for e in fired)
    assert cancels == (n if interrupting else 0)
    if not interrupting:  # the hosts still wait on their jobs
        assert _roots_completed(fired) == 0


def _publishes(meta, n, name):
    cols = tb.batch_to_numpy(tb.empty(n, NUM_VARS, device="cpu"))
    cols["valid"][:] = True
    cols["rtype"][:] = int(RecordType.COMMAND)
    cols["vtype"][:] = int(ValueType.MESSAGE)
    cols["intent"][:] = int(MI.PUBLISH)
    cols["type_id"][:] = meta.interns.intern(name)
    cols["retries"][:] = VT_STR
    cols["worker"][:] = [meta.interns.intern(f"c-{i}") for i in range(n)]
    return cols


def test_dual_boundaries_disarm_and_terminate_catch_scans():
    """A receive task with an interrupting message boundary and a timer
    boundary: a third of the instances get "abort" (the timer is disarmed
    AND re-scanned by TERMINATE_CATCH_EVENT: two cancels), a third "main"
    (both boundaries disarmed), the rest time out (the message boundary's
    subscription closes)."""
    jgraph, meta = _compiled(dual_boundary_process())
    assert jgraph.has_boundaries and jgraph.has_messages and jgraph.has_timers
    n = 12
    jstate, created, over = walk(jgraph, _state(meta, 256),
                                 _creates(meta, n, "cid", strings=True), 8, 60, now=NOW)
    assert _rows(created, ValueType.TIMER, TI.CREATED) == n
    cols = _publishes(meta, n, "abort")
    cols["type_id"][4:8] = meta.interns.intern("main")
    cols["valid"][8:] = False
    jstate, hit, over2 = walk(jgraph, jstate, jb.RecordBatch(**cols), 8, 60, now=NOW)
    cancels = _rows(hit, ValueType.TIMER, TI.CANCEL, int(RecordType.COMMAND))
    assert cancels == 4 * 2 + 4  # abort: disarm + terminate scan; main: disarm
    trig, count = assert_tick_equal(jstate, NOW + 61_000)
    assert count == n - 8
    jstate, fired, over3 = walk(jgraph, jstate, trig, 8, 60, now=NOW + 61_000)
    assert over == over2 == over3 == 0
    assert _roots_completed(hit) + _roots_completed(fired) == n


def test_tick_kernel_on_random_due_timers_and_jobs():
    rng = np.random.default_rng(3)
    arrays = ts.state_to_numpy(ts.make_state(capacity=512, num_vars=NUM_VARS,
                                             timer_capacity=256, device="cpu"))
    t, m = arrays["timer_key"].shape[0], arrays["job_i32"].shape[0]
    live_t = rng.random(t) < 0.7
    keys = rng.permutation(10**6)[: t + m] * 5 + 3  # unique across both tables
    arrays["timer_key"][:] = np.where(live_t, keys[:t], -1)
    arrays["timer_due"][:] = rng.integers(0, 2 * NOW, size=t)
    arrays["timer_aik"][:] = rng.integers(0, 10**6, size=t)
    arrays["timer_instance_key"][:] = rng.integers(0, 10**6, size=t)
    arrays["timer_elem"][:] = rng.integers(0, 9, size=t)
    arrays["timer_wf"][:] = rng.integers(0, 3, size=t)
    arrays["job_i32"][:] = rng.integers(-1, 12, size=arrays["job_i32"].shape)
    arrays["job_i32"][:, ts.JB_STATE] = rng.choice([-1, int(JI.CREATED), int(JI.ACTIVATED)],
                                                   size=m)
    arrays["job_i64"][:] = rng.integers(0, 10**6, size=arrays["job_i64"].shape)
    arrays["job_i64"][:, ts.JBL_KEY] = keys[t:]
    arrays["job_i64"][:, ts.JBL_DEADLINE] = rng.integers(-1, 2 * NOW, size=m)
    arrays["job_pay"].view(np.int32)[:] = rng.integers(-2**31, 2**31 - 1,
                                                       size=arrays["job_pay"].shape)
    jstate = js.EngineState(**{
        f: (js.hashmap.HashTable(jnp.asarray(arrays[f + ".keys"]),
                                 jnp.asarray(arrays[f + ".vals"]))
            if f in ts.MAP_FIELDS else jnp.asarray(arrays[f]))
        for f in ts.STATE_FIELDS
    })
    for now in (0, NOW, 2 * NOW):
        _out, count = assert_tick_equal(jstate, now)
        assert (count > 0) == (now > 0)


@pytest.mark.parametrize("size", [64, 4096])
def test_armed_timer_scan_equals_the_dense_form(size):
    rng = np.random.default_rng(size)
    t = 1024
    st = ts.make_state(capacity=512, num_vars=2, timer_capacity=t, device="cpu")
    aiks = rng.integers(0, size // 4, size=t) * 5 + 1
    st.timer_key[:] = torch.from_numpy(np.where(rng.random(t) < 0.6,
                                                rng.integers(0, 10**6, size=t), -1))
    st.timer_aik[:] = torch.from_numpy(aiks)
    keys = torch.from_numpy(rng.integers(0, size // 4, size=size) * 5 + 1)
    keys[::9] = -1
    wants = [torch.from_numpy(rng.random(size) < p) for p in (0.5, 0.2)]
    got = tk._armed_timer_slots(st, keys, wants, 3)
    # the JAX kernel's form: [B, T] mask, its row minimum n times
    mask0 = ((st.timer_key >= 0)[None, :] & (st.timer_aik[None, :] == keys[:, None])).numpy()
    iota = np.arange(t)
    for want, slots in zip(wants, got):
        mask = mask0 & want.numpy()[:, None]
        for j in range(3):
            c = np.where(mask, iota[None, :], t).min(axis=1)
            np.testing.assert_array_equal(slots[j].numpy(), c)
            mask = mask & (iota[None, :] != np.clip(c, 0, t - 1)[:, None])


def test_chip_smoke_config4_drive_equals_the_jax_drive():
    """``chip_smoke.c4_drive`` (phases 3 and 5c) on the CPU at a wave of
    64: its CREATE and PUBLISH batches are ``bench.stage_c4_creates`` and
    ``stage_c4_publishes``, its tick ``tick_kernel``; two waves through
    the JAX package's drive loop with the same rebuild cadence end in the
    same state and totals (27 records a correlated instance, 23 an expired
    one)."""
    import chip_smoke
    from zeebe_tpu.tpu import drive as jd

    wave, waves = 64, 2
    tstate, ttot, _s = chip_smoke.c4_drive(waves, wave, "cpu")
    jgraph, meta = bench.build_graph_c4()
    for name in ("orderId", "orderValue", "paid"):
        meta.varspace.column(name)
    jgraph = dataclasses.replace(jgraph, num_vars=max(jgraph.num_vars, 8))
    v = jgraph.num_vars
    jstate = js.make_state(capacity=4 * wave, num_vars=v, job_capacity=4 * wave,
                           timer_capacity=2 * wave, msub_capacity=2 * wave,
                           msg_capacity=wave)
    jq = jd.make_queue(8 * wave * max(jgraph.emit_width // 2, 1), v)
    jtot = {"processed": 0, "completed_roots": 0}
    for i in range(waves):
        now = i * chip_smoke.C4_WAVE_STRIDE_MS
        for batch, at in ((bench.stage_c4_creates(meta, wave, v, i * wave), now),
                          (bench.stage_c4_publishes(meta, wave, v, i * wave), now),
                          (None, now + chip_smoke.C4_TICK_MS)):
            if batch is None:
                jstate, batch, _n = jk.tick_jit(jstate, jnp.asarray(at, jnp.int64))
            jq = jd.enqueue(jq, batch)
            jstate, jq, t = jd.run_to_quiescence(jgraph, jstate, jq, at, wave)
            for k in jtot:
                jtot[k] += int(t[k])
        if i % chip_smoke.REBUILD_EVERY == 0:
            jstate = js.rebuild_lookup_state(jstate)
    assert {k: ttot[k] for k in jtot} == jtot
    assert ttot["processed"] == waves * wave // 2 * (
        chip_smoke.C4_PER_CORRELATED + chip_smoke.C4_PER_EXPIRED)
    want, got = jax_state_np(jstate), ts.state_to_numpy(tstate)
    for name in want:
        _assert_leaf(name, got[name], want[name])


def test_chip_smoke_counts_are_the_host_oracles():
    """The records per instance chip_smoke holds configs 4 and 5 to (phases
    3, 5c, 5d and 6a) are what the port's host oracle writes: a correlated
    config-4 instance, an expired one, one up to its wait on the receive
    task, a config-5 instance."""
    import chip_smoke

    assert chip_smoke.oracle_counts() == {
        "config4_correlated": chip_smoke.C4_PER_CORRELATED,
        "config4_expired": chip_smoke.C4_PER_EXPIRED,
        "config4_waiting": chip_smoke.C4_PER_WAITING,
        "config5": chip_smoke.TRANSITIONS_PER_INSTANCE_C5,
    }
