"""The port's device job backlog: the typed probe, the round-robin cursor and
the broker tick's gated pull, held to the JAX engine.

After ``tests/test_job_backlog_probe.py``: ``CudaPartitionEngine`` on the
CPU with device-table jobs and subscriptions written into its torch
tables, beside the JAX ``TpuPartitionEngine`` with the same tables. The
probe's backlog bit is set on a type match and clear for an orphan job or
exhausted credits (the same mask as the JAX ``_due_probe_jit``); the
backlog pull assigns in turns, continues the rotation across calls and
after a snapshot restore, and writes the JAX engine's ACTIVATE commands;
the port's ``Broker.tick`` pays for the pull only behind the probe bit.
"""

import dataclasses

import numpy as np
import torch

from zeebe_tpu.protocol.intents import JobIntent as JI

import zeebe_tpu_torch.runtime as port_runtime
from zeebe_tpu_torch.tpu.engine import (
    PROBE_DEADLINES,
    PROBE_JOB_BACKLOG,
    CudaPartitionEngine,
    _due_probe_kernel,
)


def port_engine(n_jobs, sub_specs, job_type="work"):
    """``CudaPartitionEngine`` on the CPU with ``n_jobs`` CREATED device
    jobs of ``job_type`` and a subscription per (key, type, credits)."""
    eng = CudaPartitionEngine(capacity=256, sub_capacity=8, device="cpu")
    s = eng.state
    tid = eng.interns.intern(job_type)
    for i in range(n_jobs):
        s.job_i32[i] = torch.tensor((int(JI.CREATED), 0, 0, tid, 3, 0))
        s.job_i64[i] = torch.tensor((100 + 5 * i, -1, -1, -1))
    for slot, (key, stype, credits) in enumerate(sub_specs):
        s.sub_key[slot] = key
        s.sub_type[slot] = eng.interns.intern(stype)
        s.sub_worker[slot] = eng.interns.intern(f"worker-{key}")
        s.sub_credits[slot] = credits
        s.sub_timeout[slot] = 1000
        s.sub_valid[slot] = True
    return eng


def jax_engine(n_jobs, sub_specs, job_type="work"):
    """``tests/test_job_backlog_probe.py``'s fixture."""
    import jax.numpy as jnp

    from zeebe_tpu.tpu.engine import TpuPartitionEngine

    eng = TpuPartitionEngine(capacity=256, sub_capacity=8)
    s = eng.state
    tid = eng.interns.intern(job_type)
    t = {name: np.asarray(getattr(s, name)).copy() for name in (
        "job_i32", "job_i64", "sub_key", "sub_type", "sub_worker",
        "sub_credits", "sub_timeout", "sub_valid")}
    for i in range(n_jobs):
        t["job_i32"][i] = (int(JI.CREATED), 0, 0, tid, 3, 0)
        t["job_i64"][i] = (100 + 5 * i, -1, -1, -1)
    for slot, (key, stype, credits) in enumerate(sub_specs):
        t["sub_key"][slot] = key
        t["sub_type"][slot] = eng.interns.intern(stype)
        t["sub_worker"][slot] = eng.interns.intern(f"worker-{key}")
        t["sub_credits"][slot] = credits
        t["sub_timeout"][slot] = 1000
        t["sub_valid"][slot] = True
    eng.state = dataclasses.replace(s, **{k: jnp.asarray(v) for k, v in t.items()})
    return eng


def masks(n_jobs, sub_specs):
    """The probe's mask at time 0 on both engines."""
    import jax.numpy as jnp

    from zeebe_tpu.tpu.engine import _due_probe_jit

    port = int(port_engine(n_jobs, sub_specs).deadlines_due_probe())
    eng = jax_engine(n_jobs, sub_specs)
    eng.state, jax_mask = _due_probe_jit(eng.state, jnp.asarray(0, jnp.int64))
    return port, int(jax_mask)


def test_backlog_bit_set_on_type_match():
    port, jax = masks(2, [(1, "work", 5)])
    assert port == jax
    assert port & PROBE_JOB_BACKLOG
    assert not port & PROBE_DEADLINES


def test_orphan_job_with_unmatched_credits_keeps_bit_clear():
    port, jax = masks(1, [(1, "other-type", 5)])
    assert port == jax
    assert not port & PROBE_JOB_BACKLOG
    # and the pull it gates would indeed find nothing
    assert port_engine(1, [(1, "other-type", 5)]).device_backlog_activations() == []


def test_exhausted_credits_keep_bit_clear():
    port, jax = masks(2, [(1, "work", 0)])
    assert port == jax
    assert not port & PROBE_JOB_BACKLOG
    eng = port_engine(2, [(1, "work", 0)])
    assert int(_due_probe_kernel(eng.state, 0)) == port


def _activations(records):
    return [(r.key, r.metadata.request_stream_id, r.value.worker, r.value.deadline)
            for r in records]


def test_assignments_alternate_within_a_call():
    specs = [(1, "work", 10), (2, "work", 10)]
    out = port_engine(4, specs).device_backlog_activations()
    assert [r.metadata.request_stream_id for r in out] == [1, 2, 1, 2]
    assert _activations(out) == _activations(
        jax_engine(4, specs).device_backlog_activations())


def test_cursor_persists_across_calls():
    specs = [(1, "work", 10), (2, "work", 10)]
    eng = port_engine(1, specs)
    first = eng.device_backlog_activations()
    # the port leaves a job whose ACTIVATE is written and not processed out
    # of the next pull (ROADMAP Queue 3); here that ACTIVATE has
    # been processed and the table still says CREATED, as in the fixture
    eng.note_unprocessed([])
    second = eng.device_backlog_activations()
    assert first[0].metadata.request_stream_id == 1
    assert second[0].metadata.request_stream_id == 2
    assert int(eng.state.sub_rr) == 0  # wrapped around
    ref = jax_engine(1, specs)
    assert _activations(first + second) == _activations(
        ref.device_backlog_activations() + ref.device_backlog_activations())


def test_cursor_survives_snapshot_restore():
    eng = port_engine(1, [(1, "work", 10), (2, "work", 10)])
    eng.device_backlog_activations()  # moves the cursor to 1
    assert int(eng.state.sub_rr) == 1
    restored = CudaPartitionEngine(capacity=256, sub_capacity=8, device="cpu")
    restored.restore_state(eng.snapshot_state())
    assert int(restored.state.sub_rr) == 1
    # and across the engines: the JAX engine restores the port's snapshot
    from zeebe_tpu.tpu.engine import TpuPartitionEngine

    ref = TpuPartitionEngine(capacity=256, sub_capacity=8)
    ref.restore_state(eng.snapshot_state())
    assert int(np.asarray(ref.state.sub_rr)) == 1


def test_device_pull_gated_by_probe_bit(tmp_path):
    """The port's ``Broker.tick`` reads the probe before it pays for the
    backlog pull: a clear bit skips the pull."""
    broker = port_runtime.Broker(num_partitions=1, data_dir=str(tmp_path / "d"))
    partition = broker.partitions[0]
    calls = {"pull": 0}

    class GatedEngine:
        def __init__(self, inner, mask):
            self._inner = inner
            self._mask = mask

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def deadlines_due_probe(self):
            return self._mask

        def device_backlog_activations(self):
            calls["pull"] += 1
            return []

    try:
        partition.engine = GatedEngine(partition.engine, 0)
        broker.tick()
        assert calls["pull"] == 0
        partition.engine = GatedEngine(partition.engine._inner, PROBE_JOB_BACKLOG)
        broker.tick()
        assert calls["pull"] == 1
    finally:
        broker.close()
