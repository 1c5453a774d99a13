#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA engine (``zeebe_tpu_torch``).

Builds the hand-written CUDA kernels from ``zeebe_tpu_torch/csrc`` (phase
1), holds each of the 14 kernel wrappers against its plain PyTorch
version on the card at the main paths' shapes and times it: around one
wrapper call (host work inside), and also on the host alone and on the
device alone, back to back (phase 2; the scatters' adds and maxima also
as config 3's pair in one ``fused_accumulate``, the row loop also pass
by pass and at n_writes 10; the
lookup also as a config-1 step's fused fallback probes against two
calls and as config 4's five probes in one launch, the insert also at the rebuild shape, round 1 alone, and captured
in a CUDA graph, the delete also on chains that wrap past the table's
end or run out, and as the step's two and the demotion's four deletes in
one ``fused_delete``), and runs table commits and inserts from two
threads at once, bit-equal to the same calls one thread after the other
(the claim scratch the threads share). It checks the drive loop on the card bit-equal to the same
loop on the CPU on configs 1, 3, 2, 4 (with its tick) and 5 and an
I/O-mapping graph, one config-4 wave at full width (the main path's
launch shapes), one mixed and one timer step and two ``tick_kernel``
calls, and the host oracle's records per instance of configs 4 and 5
(phase 3), then drives, at the benchmark's accelerator width and
through the package's own entry points, config 1 (the order-process:
start → service task "payment-service" → end; phase 4), config 3
(parallel fork/join; phase 5), config 2 (an exclusive gateway with a
json-el condition; phase 5b), config 4 (a receive task with an
interrupting 30 s timer boundary: CREATE, PUBLISH for the even half, the
tick 31 s later; phase 5c) and config 5 (a cardinality-4 multi-instance
sub-process; phase 5d), with synthetic instant workers, and shows from
the launch counters that each run went through every kernel of its path,
exactly as often as its rounds, ticks and rebuilds ask, and that no table
commit enqueued more than 3 device launches; each config-4 drive processes
the host oracle's records per instance of the half it serves. Phase 6 serves through the
port's in-process ``Broker`` with ``CudaPartitionEngine`` — client → log
→ engine → job pushed to a worker → completion → log: the first engine's
construction runs the boot self-check (insert, lookup, delete, row
update, lane update and lane accumulate against their plain versions,
bit for bit); 6a serves configs 1, 3 and 2, a timer-catch workflow (the
clock moved past the timers), config 4 (a burst of PUBLISHes for the even
half, the clock moved 31 s: each stage's records held to the oracle's)
and config 5, and checks every instance completed device-served (the message store on the card) with every
kernel of the path launched; 6b checks credit-drought logs on the card
equal to the same runs' on the CPU, and config 2's, the timers', config
4's and config 5's equal to the port's host oracle at full credit. Phase
7 runs the primitive-cost probe
(``zeebe_tpu_torch.probe``: the row loop and the hash probe against
``index_put_``). Phase 8 serves the cluster path (``bench.py:312``
``run_serving_path``): 8a, 2,048 instances from 8 threads through
``ClusterClient`` over TCP to one ``ClusterBroker`` (raft append and
commit, the wave scheduler's drain) with ``[engine] type = "cuda"``, every
instance completed once, rates, latency percentiles and host and device
seconds, then the same with the host oracle, whose log must hold the same
records; 8b, three brokers with two partitions on the card, each
follower holding the device snapshot, a leader closed and its successor
restored from the snapshot serving on; 8c, ``python -m zeebe_tpu_torch``
with ``ZEEBE_ENGINE_TYPE=cuda`` started, served and stopped with SIGTERM;
8d, a stranded job on one node (a worker with one credit holds the first
job, the second is created with no credit free, the first one's deadline
passes, the credit comes back): the tick's ``PROBE_JOB_BACKLOG`` scan
activates one of them, once. The served runs that go quiet (6a, 8a, 8b,
8d, 9b, 10a) end with no job record in flight in any engine
(``CudaPartitionEngine.job_records_in_flight``).
Phase 9 runs the mesh (9a one partition's state over spans of places, 9b
``bench.py:787``'s mesh serving). Phase 10 runs the production planes:
10a the shared-wave scheduler (``tools/scheduler_smoke.py``'s mix and
2,048 instances over 8 partitions in process, each partition's log equal
with the scheduler on and off and to the host oracle's; ``bench.py:501``'s
multi-tenant mix over ``ClusterBroker`` shared, baseline and overloaded,
beside the host oracle), 10b delta snapshots and a crash restore
(``tools/state_smoke.py`` at 6a's width: what each take reads back and
writes, the restored state equal to the live one and the CPU's), 10c the
trace and audit planes (spans, wave timelines, ``tools/trace_report.py``,
the JSONL audit equal to the log). Phase 11, run after phase 5d, holds the
drive's step replayed as a CUDA graph (``tpu/capture.py``) to the eager
step: a captured commit and insert replayed twice with other data and
eager inserts between, against the plain versions (and, recorded on the
card's own claim scratch, shown to differ); configs 1-5 at wave 2^14 over
a rebuild period; ``shard.build_sharded_drive``, a graph a place; and the
benchmark's two cells at 2^20 over a rebuild period of units. Each drive's
every round's emissions and every table are bit-equal, and its capture
counts are exact (one capture, every other round replayed, one rebind).

    python3 chip_smoke.py                     # the full check, one CUDA card
    python3 chip_smoke.py --profile --out F   # + one wave of each config (with
                                              #   its peak memory), one
                                              #   eval_programs call under
                                              #   torch.profiler and config 4's
                                              #   disarm timer scan, every number
                                              #   written to F (JSON)
    python3 chip_smoke.py --hash-only         # only phase 2's lookup, insert,
                                              #   delete and probe cases: run it
                                              #   in an unpacked parent commit
                                              #   and here, in one call, for an
                                              #   A/B
    python3 chip_smoke.py --mesh-only         # only the build and phase 9
    python3 chip_smoke.py --planes-only       # only the build and phase 10
    python3 chip_smoke.py --capture-only      # only the build and phase 11
    python3 chip_smoke.py --scatter-only      # only phase 2's scatter and row-
                                              #   loop cases, and the one-op
                                              #   accumulate wrapper's host work
                                              #   piece by piece (an A/B beside a
                                              #   parent's whole script)

Every phase passes or the script exits non-zero. The last line of standard
output is ``{"ok": true, "device": {...}}``; before it come the card's name
and power limit as nvidia-smi reports them and a ``{"kernels": [...]}``
line. Without a CUDA device, or without the package beside it, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

# H100 SXM device memory rate (NVIDIA data sheet); the bound of a kernel
# that moves bytes and does no arithmetic to speak of is bytes over this
HBM_BYTES_PER_S = 3.35e12

# configs 1, 2 and 3 at the benchmark's accelerator settings (bench.py:2292,
# run_device_config at bench.py:1372; configs 2 and 3 run side_total =
# total_instances // 4 instances, bench.py:2381)
WAVE = 1 << 14
INSTANCES = 1 << 20
INSTANCES_C2 = 1 << 18
INSTANCES_C3 = 1 << 18
CAP_FACTOR = 4
TRANSITIONS_PER_INSTANCE = 20
TRANSITIONS_PER_INSTANCE_C2 = 22
TRANSITIONS_PER_INSTANCE_C3 = 36
# records of a config-2 instance whose orderValue is absent: the condition
# errors and the incident stops it at the gateway
TRANSITIONS_CONDITION_INCIDENT = 8
# the I/O-mapping graph: records of an instance that runs to the end, and
# of one stopped by the input-mapping incident (no orderValue)
MAPPING_PER_INSTANCE = 20
MAPPING_PER_STOPPED = 8
REBUILD_EVERY = 3
# config 4 at run_device_config_c4's settings (bench.py:197-270, side_total
# at bench.py:2381): 2^18 instances at wave 2^14; each wave CREATEs, the
# even half's PUBLISH, then the tick 31 s later fires the odd half's 30 s
# timer boundary. Records a correlated (even) and an expired (odd) instance
# writes, its commands included, and the records of either up to its wait
# on the receive task (the host oracle's counts: phase 3)
INSTANCES_C4 = 1 << 18
C4_BOUNDARY_MS = 30_000
C4_TICK_MS = 31_000
C4_WAVE_STRIDE_MS = 100_000
C4_PER_CORRELATED = 27
C4_PER_EXPIRED = 23
C4_PER_WAITING = 12
# config 4's three drives (CREATE, the even half's PUBLISH, the tick): the
# records each writes per instance of the wave
C4_PER_DRIVE = (C4_PER_WAITING, (C4_PER_CORRELATED - C4_PER_WAITING) / 2,
                (C4_PER_EXPIRED - C4_PER_WAITING) / 2)
# config 5 at run_config5_sweep's largest wave (bench.py:1468-1490): wave
# 2^12, 8 waves, cap_factor 16; a cardinality-4 multi-instance sub-process
WAVE_C5 = 1 << 12
INSTANCES_C5 = 8 * WAVE_C5
CAP_FACTOR_C5 = 16
C5_CARDINALITY = 4
TRANSITIONS_PER_INSTANCE_C5 = 70
# the device functions of zeebe_tpu_torch/csrc, as the profiler names them
OUR_KERNELS = ("gather_rows_kernel", "commit_pass_kernel", "scatter_accum_kernel",
               "hash_lookup_kernel", "hash_insert_kernel", "hash_delete_kernel")
# a spin of this many clock cycles (about 30 ms at 1.98 GHz) holds the
# stream while the host enqueues the launches device_us times (a slow host
# took 11.6 ms for phase 2's hundred fused-lookup calls)
SPIN_CYCLES = 60_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def current_stream() -> int:
    """The raw handle of the current card's current stream: where the
    wrappers launch on that card."""
    import torch

    from zeebe_tpu_torch.tpu import ops

    return ops._stream(torch.device("cuda", torch.cuda.current_device()))


def _enter_guard(device) -> None:
    """Enter and leave a wrapper's launch guard (its host cost)."""
    from zeebe_tpu_torch.tpu import ops

    with ops._device_guard(device):
        pass


def smi_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return res.stdout.strip().splitlines()[0] if res.stdout.strip() else (
            f"nvidia-smi printed nothing (rc={res.returncode})"
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of one call of ``fn``, in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_us(launch, reps: int = 100) -> float:
    """Device time of one launch in microseconds: CUDA events around
    ``reps`` back-to-back calls of ``launch`` (a C entry with prebuilt
    arguments), all enqueued behind a spin kernel, so the host's work stays
    off the timed span."""
    import torch

    if launch() < 0:
        raise AssertionError("the C entry reported a CUDA error")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def host_us(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median host time of one call of ``fn`` in microseconds
    (``time.perf_counter``, no synchronisation inside the span)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def device_us_calls(calls) -> float:
    """Device time of one call in microseconds: ``calls`` are zero-argument
    calls (each on inputs of its own where a call changes them: an insert,
    a delete); the first warms up, the rest are enqueued back to back
    behind a spin kernel, so the host's work stays off the timed span.
    Counts every kernel a call enqueues. Raises if the host took longer to
    enqueue them than the spin held the stream (the device would have
    waited on the host)."""
    import torch

    calls[0]()
    torch.cuda.synchronize()
    spun = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spun.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for call in calls[1:]:
        call()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    if enqueue_ms >= spun.elapsed_time(start):
        raise AssertionError(f"enqueueing took {enqueue_ms:.2f} ms, longer than the spin")
    return start.elapsed_time(end) * 1e3 / (len(calls) - 1)


def max_abs_err(got, want) -> float:
    """Largest |difference| between two lists of tensors, compared as the
    integers of their bit patterns (floats through their int32 view): 0.0
    means bit-identical."""
    import torch

    worst = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype differ: {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        if d.numel():
            worst = max(worst, int(d.max()))
    return float(worst)


# ---------------------------------------------------------------------------
# configs 1 and 3
# ---------------------------------------------------------------------------


def config1_model():
    """Config 1 (bench.py:39 ``build_graph``): the order-process."""
    from zeebe_tpu_torch.models.bpmn.builder import Bpmn

    return (
        Bpmn.create_process("order-process")
        .start_event("start")
        .service_task("collect-money", type="payment-service")
        .end_event("end")
        .done()
    )


def config3_model():
    """Config 3 (bench.py:72 ``build_graph_forkjoin``): a parallel gateway
    forks into two service tasks that a second parallel gateway joins."""
    from zeebe_tpu_torch.models.bpmn.builder import Bpmn
    from zeebe_tpu_torch.models.bpmn.model import ParallelGateway

    builder = (
        Bpmn.create_process("fork-process")
        .start_event("start")
        .parallel_gateway("fork")
    )
    join = ParallelGateway(id="join")
    join.scope_id = "fork-process"
    builder.model.add(join)
    builder.branch().service_task("task-a", type="payment-service").connect_to("join")
    builder.branch().service_task("task-b", type="payment-service").connect_to("join")
    builder.move_to("join").end_event("end")
    return builder.done()


def config2_model():
    """Config 2 (bench.py:53 ``build_graph_xor``): an exclusive gateway
    sends orderValue > 50 to one service task and, by default, the rest to
    another (BASELINE.json configs[1])."""
    from zeebe_tpu_torch.models.bpmn.builder import Bpmn

    builder = (
        Bpmn.create_process("xor-process")
        .start_event("start")
        .exclusive_gateway("split")
    )
    builder.branch("$.orderValue > 50").service_task(
        "big", type="payment-service"
    ).end_event("end-big")
    builder.branch(default=True).service_task(
        "small", type="payment-service"
    ).end_event("end-small")
    return builder.done()


def mapping_model():
    """A service task with input and output mappings (the has_mappings
    gate): orderValue → amount and orderId → ref in, amount → outcome out;
    an instance without orderValue raises the input-mapping incident."""
    from zeebe_tpu_torch.models.bpmn.builder import Bpmn

    return (
        Bpmn.create_process("mapped")
        .start_event("start")
        .service_task("work", type="payment-service",
                      inputs=[("$.orderValue", "$.amount"), ("$.orderId", "$.ref")],
                      outputs=[("$.amount", "$.outcome")])
        .end_event("end")
        .done()
    )


TIMER_MS = 10_000


def timer_model():
    """start → 10 s timer catch event → service task → end (the has_timers
    gate; ``timer_process`` of tests/test_torch_serving.py with the
    benchmark's job type)."""
    from zeebe_tpu_torch.models.bpmn.builder import Bpmn

    return (
        Bpmn.create_process("timed")
        .start_event("start")
        .timer_catch_event("wait", duration_ms=TIMER_MS)
        .service_task("after", type="payment-service")
        .end_event("end")
        .done()
    )


def config4_model():
    """Config 4 (bench.py:282 ``_config4_model``, BASELINE.json configs[3]):
    a receive task waiting on "paid" (correlation key $.oid) with an
    interrupting 30 s timer boundary."""
    from zeebe_tpu_torch.models.bpmn.builder import Bpmn

    return (
        Bpmn.create_process("c4")
        .start_event("start")
        .receive_task("wait-pay", message_name="paid", correlation_key="$.oid")
        .boundary_event("deadline", duration_ms=C4_BOUNDARY_MS)
        .end_event("expired")
        .move_to("wait-pay")
        .end_event("done")
        .done()
    )


def config5_model():
    """Config 5 (bench.py:298 ``_config5_model``, BASELINE.json configs[4]):
    a cardinality-4 multi-instance sub-process around a service task."""
    from zeebe_tpu_torch.models.bpmn.builder import Bpmn

    builder = Bpmn.create_process("c5")
    sub = builder.start_event("start").sub_process(
        "each", multi_instance={"cardinality": C5_CARDINALITY}
    )
    sub.start_event("s").service_task("work", type="payment-service").end_event("e")
    return sub.embedded_done().end_event("done").done()


def mixed_order_values(n, seed=0):
    """(orderValue per instance, absent mask): 10 or 99 in turns drawn from
    ``seed``, absent in about one of eight — the default flow, the
    conditioned flow and the condition-error incident all run."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.choice([10.0, 99.0], size=n), rng.random(n) < 0.125


def config_graph(device, model_fn=config1_model):
    from zeebe_tpu_torch.models.transform.transformer import transform_model
    from zeebe_tpu_torch.tpu import graph as graph_mod

    workflows = transform_model(model_fn())
    for wf in workflows:
        wf.key = 9
        wf.version = 1
    graph, meta = graph_mod.compile_graph(workflows, device=device)
    for name in ("orderId", "orderValue", "paid"):
        meta.varspace.column(name)
    import dataclasses

    graph = dataclasses.replace(graph, num_vars=max(graph.num_vars, 8))
    return graph, meta


def config_state(meta, capacity, num_vars, device):
    from zeebe_tpu_torch.tpu import state as state_mod

    state = state_mod.make_state(
        capacity=capacity, num_vars=num_vars, job_capacity=capacity,
        join_capacity=capacity, sub_capacity=8, device=device,
    )
    # one worker subscription for "payment-service" with unbounded credit
    state.sub_key[0] = 1
    state.sub_type[0] = meta.interns.intern("payment-service")
    state.sub_worker[0] = meta.interns.intern("bench-worker")
    state.sub_credits[0] = 2**31 - 1
    state.sub_timeout[0] = 300_000
    state.sub_valid[0] = True
    return state


def config_creates(meta, wave, num_vars, device, mixed=False):
    """A wave of CREATE commands with payload {orderId, orderValue}:
    orderValue 99.0 as ``bench.stage_creates`` makes it, or with ``mixed``
    the values of ``mixed_order_values``."""
    import torch

    from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
    from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI
    from zeebe_tpu_torch.tpu import batch as rb
    from zeebe_tpu_torch.tpu.conditions import VT_NUM

    b = rb.empty(wave, num_vars, device=device)
    oid = meta.varspace.column("orderId")
    oval = meta.varspace.column("orderValue")
    b.valid.fill_(True)
    b.rtype.fill_(int(RecordType.COMMAND))
    b.vtype.fill_(int(ValueType.WORKFLOW_INSTANCE))
    b.intent.fill_(int(WI.CREATE))
    b.wf.fill_(0)
    b.v_vt[:, oid] = VT_NUM
    b.v_vt[:, oval] = VT_NUM
    b.v_num[:, oid] = torch.arange(wave, dtype=torch.float32, device=b.device)
    b.v_num[:, oval] = 99.0
    if mixed:
        values, absent = mixed_order_values(wave)
        b.v_num[:, oval] = torch.from_numpy(values.astype("float32")).to(b.device)
        b.v_vt[torch.from_numpy(absent).to(b.device), oval] = 0  # VT_ABSENT
    return b


def config_setup(wave, device, model_fn=config1_model, mixed=False, cap_factor=CAP_FACTOR):
    """Graph, state, queue and a CREATE wave for config 1 (or, with
    ``model_fn`` another config's model, that config: the same settings)."""
    from zeebe_tpu_torch.tpu import drive

    graph, meta = config_graph(device, model_fn)
    num_vars = graph.num_vars
    state = config_state(meta, cap_factor * wave, num_vars, device)
    queue = drive.make_queue(4 * wave * max(2, graph.emit_width), num_vars,
                             device=device)
    return graph, state, queue, config_creates(meta, wave, num_vars, device, mixed)


def creates_wave(graph, creates, state, queue, wave, i, device):
    """One wave of ``drive_config`` (``c4_wave``'s form): enqueue the
    CREATEs and drive to quiescence with synthetic workers. Returns (state,
    queue, [totals of the drive])."""
    from zeebe_tpu_torch.tpu import drive

    queue = drive.enqueue(queue, creates)
    state, queue, t = drive.run_to_quiescence(graph, state, queue, 0, wave,
                                              synthetic_workers=True)
    return state, queue, [t]


def drive_config(waves, wave, device, timed_from=1, model_fn=config1_model,
                 rebuild_every=REBUILD_EVERY, mixed=False, cap_factor=CAP_FACTOR):
    """Config 1 (or another) through the package's entry points: compile the
    graph, make the state and queue, then per wave enqueue CREATEs and
    drive to quiescence with synthetic workers; rebuild the lookup state
    after the first wave and every ``rebuild_every`` waves after it.
    Returns (state, totals over all waves, seconds of the waves from
    ``timed_from`` on)."""
    import torch

    from zeebe_tpu_torch.tpu import state as state_mod

    graph, state, queue, creates = config_setup(wave, device, model_fn, mixed, cap_factor)
    totals = {"processed": 0, "emitted": 0, "completed_roots": 0, "rounds": 0}
    t0 = None
    for i in range(waves):
        if i == timed_from:
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, queue, (t,) = creates_wave(graph, creates, state, queue, wave, i, device)
        for k in totals:
            totals[k] += t[k]
        if i % rebuild_every == 0:
            state = state_mod.rebuild_lookup_state(state)
    if device != "cpu":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0 if t0 is not None else 0.0
    return state, totals, elapsed


def config5_drive(waves, wave, device, timed_from=1, rebuild_every=REBUILD_EVERY):
    """Config 5 at ``run_config5_sweep``'s settings (cap_factor 16)."""
    return drive_config(waves, wave, device, timed_from, config5_model, rebuild_every,
                        cap_factor=CAP_FACTOR_C5)


def c4_setup(wave, device):
    """Graph, state, queue and meta at ``run_device_config_c4``'s settings:
    state and job capacity 4 waves, timer and subscription capacity 2,
    stored messages 1; the queue holds 8 waves times max(emit_width // 2, 1)."""
    from zeebe_tpu_torch.tpu import drive, state as state_mod

    graph, meta = config_graph(device, config4_model)
    state = state_mod.make_state(
        capacity=4 * wave, num_vars=graph.num_vars, job_capacity=4 * wave,
        timer_capacity=2 * wave, msub_capacity=2 * wave, msg_capacity=wave,
        device=device,
    )
    queue = drive.make_queue(8 * wave * max(graph.emit_width // 2, 1), graph.num_vars,
                             device=device)
    return graph, state, queue, meta


def c4_creates(meta, wave, num_vars, device, base):
    """``bench.stage_c4_creates``: CREATEs with numeric correlation keys
    oid = base + i."""
    import torch

    from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
    from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI
    from zeebe_tpu_torch.tpu import batch as rb
    from zeebe_tpu_torch.tpu.conditions import VT_NUM

    b = rb.empty(wave, num_vars, device=device)
    oid = meta.varspace.column("oid")
    b.valid.fill_(True)
    b.rtype.fill_(int(RecordType.COMMAND))
    b.vtype.fill_(int(ValueType.WORKFLOW_INSTANCE))
    b.intent.fill_(int(WI.CREATE))
    b.wf.fill_(0)
    b.v_vt[:, oid] = VT_NUM
    b.v_num[:, oid] = base + torch.arange(wave, dtype=torch.float32, device=b.device)
    return b


def c4_publishes(meta, wave, num_vars, device, base):
    """``bench.stage_c4_publishes``: PUBLISH "paid" {paid: true} for every
    EVEN oid of the wave (prefix-compacted: the first half of the rows)."""
    import numpy as np
    import torch

    from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
    from zeebe_tpu_torch.protocol.intents import MessageIntent as MI
    from zeebe_tpu_torch.tpu import batch as rb
    from zeebe_tpu_torch.tpu.conditions import VT_BOOL, VT_NUM

    half = wave // 2
    b = rb.empty(wave, num_vars, device=device)
    paid = meta.varspace.column("paid")
    worker = np.zeros((wave,), np.int32)
    worker[:half] = (base + 2 * np.arange(half)).astype(np.float32).view(np.int32)
    b.valid[:half] = True
    b.rtype.fill_(int(RecordType.COMMAND))
    b.vtype.fill_(int(ValueType.MESSAGE))
    b.intent.fill_(int(MI.PUBLISH))
    b.type_id.fill_(meta.interns.intern("paid"))
    b.retries.fill_(int(VT_NUM))
    b.worker.copy_(torch.from_numpy(worker))
    b.v_vt[:half, paid] = VT_BOOL
    b.v_num[:half, paid] = 1.0
    return b


def c4_wave(graph, meta, state, queue, wave, i, device):
    """One wave of ``run_device_config_c4`` (at now = i * 100 s): CREATE
    and drive; PUBLISH and drive; ``tick_kernel`` 31 s later, enqueue its
    TRIGGERs, drive. Raises unless each drive processed the host oracle's
    records per instance (``C4_PER_DRIVE``): the whole wave up to its wait,
    then the correlated half, then the expired half. Returns (state, queue,
    [totals of the three drives])."""
    from zeebe_tpu_torch.tpu import drive, kernel

    base, now = i * wave, i * C4_WAVE_STRIDE_MS
    parts = []
    for batch, at in ((c4_creates(meta, wave, graph.num_vars, device, base), now),
                      (c4_publishes(meta, wave, graph.num_vars, device, base), now),
                      (None, now + C4_TICK_MS)):
        if batch is None:
            batch, _count = kernel.tick_kernel(state, at)
        queue = drive.enqueue(queue, batch)
        state, queue, t = drive.run_to_quiescence(graph, state, queue, at, wave)
        parts.append(t)
    got = [t["processed"] for t in parts]
    want = [int(n * wave) for n in C4_PER_DRIVE]
    if got != want:
        raise AssertionError(f"config 4 wave {i}: the CREATE, PUBLISH and tick drives "
                             f"processed {got} records, the host oracle's {want}")
    return state, queue, parts


def c4_drive(waves, wave, device, timed_from=1, rebuild_every=REBUILD_EVERY):
    """Config 4 through the package's entry points, ``waves`` waves of
    ``c4_wave``; the lookup state rebuilt after the first wave and every
    ``rebuild_every`` after it. Returns (state, totals, seconds of the waves
    from ``timed_from`` on); the totals count the ticks too."""
    import torch

    from zeebe_tpu_torch.tpu import state as state_mod

    graph, state, queue, meta = c4_setup(wave, device)
    totals = {"processed": 0, "emitted": 0, "completed_roots": 0, "rounds": 0, "ticks": 0}
    t0 = None
    for i in range(waves):
        if i == timed_from:
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, queue, parts = c4_wave(graph, meta, state, queue, wave, i, device)
        for t in parts:
            for k in ("processed", "emitted", "completed_roots", "rounds"):
                totals[k] += t[k]
        totals["ticks"] += 1
        if i % rebuild_every == 0:
            state = state_mod.rebuild_lookup_state(state)
    if device != "cpu":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0 if t0 is not None else 0.0
    return state, totals, elapsed


def profile_config(wave, setup, one_wave, warm_waves=2):
    """One full-width wave of a config under torch.profiler, after
    ``warm_waves`` unprofiled ones: ``setup(wave, "cuda")`` gives (graph,
    state, queue, the wave's inputs) and ``one_wave`` runs a wave of them
    (``config_setup`` and ``creates_wave``, or ``c4_setup`` and
    ``c4_wave``). Wall time, summed device kernel time, the device's idle
    share, the kernels that take the device time and the wave's peak
    device memory; and the lookup-state rebuild after it, profiled alone:
    our kernels' device time there (the six map inserts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zeebe_tpu_torch.tpu import state as state_mod

    graph, state, queue, inputs = setup(wave, "cuda")
    for i in range(warm_waves):
        state, queue, _parts = one_wave(graph, inputs, state, queue, wave, i, "cuda")
        state = state_mod.rebuild_lookup_state(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, queue, parts = one_wave(graph, inputs, state, queue, wave, warm_waves,
                                       "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    # device-side events only: an operator's device time is also its kernels'
    events, dev_us = _device_events(prof)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:15]
    top += [e for e in events
            if e not in top and any(k in e.key for k in OUR_KERNELS)]
    # the lookup-state rebuild that follows the wave (six map inserts)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as rprof:
        t0 = time.perf_counter()
        state = state_mod.rebuild_lookup_state(state)
        torch.cuda.synchronize()
        rwall = time.perf_counter() - t0
    revents, _ = _device_events(rprof)
    return {
        "wave": wave, "rounds": sum(t["rounds"] for t in parts), "wall_ms": wall * 1e3,
        "peak_bytes": peak, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
        "device_launches": sum(e.count for e in events),
        "top": [{"name": e.key[:90], "device_ms": dev_us(e) / 1e3, "count": e.count}
                for e in top],
        "rebuild": {
            "wall_ms": rwall * 1e3,
            "device_busy_ms": sum(dev_us(e) for e in revents) / 1e3,
            "ours": [{"name": e.key[:90], "device_ms": dev_us(e) / 1e3, "count": e.count}
                     for e in revents if any(k in e.key for k in OUR_KERNELS)],
        },
    }


def profile_disarm_scan(wave):
    """The boundary disarm's timer scan at config 4's width: ``wave``
    instances wait on their receive task with a 30 s timer armed (2 waves
    of timer capacity), and a step's worth of keys (every waiting
    instance's) scans for its armed timers twice, as a step does (disarm
    and TERMINATE_CATCH_EVENT). CUDA-event ms of the port's scan (a sort
    and a binary search), and of the JAX kernel's dense [B, T] form in
    PyTorch for comparison, with each one's peak device memory."""
    import torch

    from zeebe_tpu_torch.tpu import drive, kernel

    graph, state, queue, meta = c4_setup(wave, "cuda")
    queue = drive.enqueue(queue, c4_creates(meta, wave, graph.num_vars, "cuda", 0))
    state, queue, _t = drive.run_to_quiescence(graph, state, queue, 0, wave)
    keys = state.timer_aik[state.timer_key >= 0][:wave].contiguous()
    want = torch.ones_like(keys, dtype=torch.bool)
    t_cap = state.timer_key.shape[0]
    t_iota = torch.arange(t_cap, dtype=torch.int32, device="cuda")

    def ours():
        return kernel._armed_timer_slots(state, keys, [want, want], 1)

    def dense():
        out = []
        for m in (want, want):
            mask = (m[:, None] & (state.timer_key >= 0)[None, :]
                    & (state.timer_aik[None, :] == keys[:, None]))
            out.append(torch.where(mask, t_iota[None, :], t_cap).amin(dim=1))
            del mask
        return out

    if [int((s[0] < t_cap).sum()) for s in ours()] != [wave, wave]:
        raise AssertionError("disarm scan: not every waiting instance found its timer")
    row = {"keys": wave, "timers": t_cap}
    for name, fn in (("scan", ours), ("dense", dense)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        row[name + "_ms"] = time_ms(fn)
        row[name + "_peak_extra_bytes"] = torch.cuda.max_memory_allocated() - base
    return row


def _device_events(prof):
    """(events with device time, device µs of an event) of a profile."""
    import torch

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages()
              if dev_us(e) > 0 and e.device_type != torch.autograd.DeviceType.CPU]
    return events, dev_us


def profile_eval_programs(wave):
    """One ``conditions.eval_programs`` call of config 2's split gateway at
    wave width (B = ``wave`` records × its flows) alone: CUDA-event ms and,
    under torch.profiler, device ms and device ops. Every round of a
    config-2 step runs it once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zeebe_tpu_torch.tpu.conditions import eval_programs

    graph, meta = config_graph("cuda", config2_model)
    creates = config_creates(meta, wave, graph.num_vars, "cuda", mixed=True)
    fan, v = graph.cond_flows.shape[2], graph.num_vars
    cprog = graph.cond_prog[0, meta.elem_idx[0]["split"]][None, :].expand(wave, fan)

    def call():
        return eval_programs(graph.progs, graph.lit_nums, cprog,
                             creates.v_vt[:, None, :].expand(wave, fan, v),
                             creates.v_num[:, None, :].expand(wave, fan, v),
                             creates.v_str[:, None, :].expand(wave, fan, v))

    ms = time_ms(call)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    events, dev_us = _device_events(prof)
    return {"wave": wave, "flows": fan, "program_length": graph.progs.shape[1],
            "ms": ms, "device_ms": sum(dev_us(e) for e in events) / 1e3,
            "device_launches": sum(e.count for e in events)}


def profile_selfcheck():
    """The boot self-check run once more under torch.profiler: device µs
    per launch of each of our kernels it runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zeebe_tpu_torch.tpu import ops

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ops._selfcheck_on("cuda")
        torch.cuda.synchronize()
    events, dev_us = _device_events(prof)
    return [{"name": e.key[:60], "count": e.count, "device_us": dev_us(e) / e.count}
            for e in events if any(k in e.key for k in OUR_KERNELS)]


def profile_serving(workdir, instances):
    """Config 1 served through the Broker (``instances`` instances) under
    torch.profiler: wall time, device busy time and idle share, and the
    kernels that take the device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _engine, records, wall, _ticks = serve(config1_model, instances, "cuda", workdir)
    events, dev_us = _device_events(prof)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:10]
    top += [e for e in events if e not in top and any(k in e.key for k in OUR_KERNELS)]
    return {
        "instances": instances, "records": len(records), "wall_ms": wall * 1e3,
        "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
        "device_launches": sum(e.count for e in events),
        "top": [{"name": e.key[:90], "device_ms": dev_us(e) / 1e3, "count": e.count}
                for e in top],
    }


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at main-path shapes
# ---------------------------------------------------------------------------


def check_gather(dev, gen):
    """The phase-B/C state gather of one round (N = M = 2^16, B = 2^14,
    V = 8) plus the emission-take tables, with adversarial slots."""
    import torch

    from zeebe_tpu_torch.tpu import ops

    n = m = CAP_FACTOR * WAVE
    b = WAVE
    v = 8

    def ri(shape, dtype=torch.int32):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                             dtype=torch.int64).to(dtype).to(dev)

    ei_i32 = ri((n, 6))
    ei_i64 = torch.randint(-2**62, 2**62, (n, 3), generator=gen).to(dev)
    ei_pay = ri((n, 3 * v))
    job_i32 = ri((m, 6))
    job_i64 = torch.randint(-2**62, 2**62, (m, 4), generator=gen).to(dev)
    job_pay = ri((m, 3 * v))
    # f32 table of raw bit patterns: NaNs with payloads, infinities, -0.0
    f32 = ri((2 * b, v)).view(torch.float32)
    f32[0, 0] = float("nan")
    i8 = torch.randint(-128, 127, (2 * b, v), generator=gen, dtype=torch.int8).to(dev)
    flags = (torch.rand((2 * b,), generator=gen) < 0.5).to(dev)
    tables = [ei_i32, ei_i64, ei_pay, job_i32, job_i64, job_pay,
              ei_i64[:, 0], f32, i8, flags]

    def slots(k, t):
        # in range, plus duplicates, -1, -t-3, t, t+7
        s = torch.randint(0, t, (k,), generator=gen, dtype=torch.int32)
        s[: k // 8] = s[0]
        s[1::97] = -1
        s[2::101] = -t - 3
        s[3::103] = t
        s[4::107] = t + 7
        return s.to(dev)

    gops = [
        ops.GatherOp(0, slots(3 * b, n)), ops.GatherOp(0, slots(b, n)),
        ops.GatherOp(1, slots(b, n)), ops.GatherOp(2, slots(b, n)),
        ops.GatherOp(2, slots(b, n)), ops.GatherOp(3, slots(b, m)),
        ops.GatherOp(4, slots(b, m)), ops.GatherOp(5, slots(b, m)),
        ops.GatherOp(6, slots(3 * b, n)), ops.GatherOp(7, slots(2 * b, 2 * b)),
        ops.GatherOp(8, slots(2 * b, 2 * b)), ops.GatherOp(9, slots(2 * b, 2 * b)),
    ]
    got = ops.fused_gather_rows(tables, gops)
    want = ops.fused_gather_rows_reference(tables, gops)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0.0:
        raise AssertionError(f"gather_rows differs from its plain version: {err}")
    # int64 slots beyond the int32 range (checked, not timed): clamped into
    # it before the cast, they read the plain version's rows
    wide = torch.tensor([2**31, -2**31, 2**31 - 1, -2**31 - 1, 2**32 + 5, -2**32 + 3,
                         2**40, -2**40, -1, 0], dtype=torch.int64)
    wide = torch.cat([wide, torch.randint(-n, n, (b,), generator=gen)]).to(dev)
    wops = [ops.GatherOp(t, wide) for t in (0, 2, 4, 6, 9)]
    werr = max_abs_err(ops.fused_gather_rows(tables, wops),
                       ops.fused_gather_rows_reference(tables, wops))
    if werr != 0.0:
        raise AssertionError(f"gather_rows with int64 slots differs: {werr}")
    nbytes = 0
    for op in gops:
        t = tables[op.table]
        row = t.element_size() * (t.shape[1] if t.dim() == 2 else 1)
        nbytes += op.slots.numel() * (4 + 2 * row)  # slot, row read, row written
    idx64 = [
        ops._wrap_slots(op.slots, tables[op.table].shape[0])
        .clamp(0, tables[op.table].shape[0] - 1) for op in gops
    ]

    def library():
        return [tables[op.table].index_select(0, ix) for op, ix in zip(gops, idx64)]

    args, _outs, _keep = ops._gather_args(tables, gops)
    fn, stream = ops._gather_fn(), current_stream()
    # the outputs' allocation: one torch.empty per op, or one arena split
    # into views (the wrapper's choice rests on these two numbers)
    shapes = [((op.slots.shape[0],) + tuple(tables[op.table].shape[1:]),
               tables[op.table].dtype) for op in gops]
    sizes = [-(-torch.Size(sh).numel() * torch.empty((), dtype=dt).element_size() // 16) * 16
             for sh, dt in shapes]

    def arena():
        flat = torch.empty((sum(sizes),), dtype=torch.uint8, device=dev)
        return [part.view(dt).view(sh) for part, (sh, dt)
                in zip(flat.split(sizes), shapes)]

    return {
        "name": "fused_gather_rows", "route": "cuda",
        "source": "zeebe_tpu_torch/csrc/gather_rows.cu",
        "replaces": "zeebe_tpu/tpu/pallas_ops.py:789",
        "max_abs_err": max(err, werr),
        "ms": time_ms(lambda: ops.fused_gather_rows(tables, gops)),
        "plain_ms": time_ms(lambda: ops.fused_gather_rows_reference(tables, gops)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        # yardstick: one index_select per op on pre-clamped int64 slots
        "library_ms": time_ms(library),
        "device_us": device_us(lambda: fn(ctypes.byref(args), stream)),
        "host_us": host_us(lambda: ops.fused_gather_rows(tables, gops)),
        "device_launches": 1,
        "library_device_us": device_us(lambda: (library(), 0)[1]),
        "library_host_us": host_us(library),
        "alloc_us": {
            "per_op": host_us(lambda: [torch.empty(sh, dtype=dt, device=dev)
                                       for sh, dt in shapes]),
            "arena": host_us(arena),
        },
        "shape": f"{len(gops)} ops, B={b}, N=M={n}, V={v} (+{len(wops)} ops of "
                 f"{wide.numel()} int64 slots, checked only)",
    }


def check_commit(dev, gen):
    """An element-instance-group commit (N = 2^16, B = 2^14, V = 8) with
    duplicate slots, masked lanes, add/max, 1D tables and the sentinel T."""
    import torch

    from zeebe_tpu_torch.tpu import ops

    n = CAP_FACTOR * WAVE
    b = WAVE
    v = 8

    def ri(shape, lo=-1000, hi=1000):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32).to(dev)

    base = [ri((n, 6)), torch.randint(-2**40, 2**40, (n, 3), generator=gen).to(dev),
            ri((n, 3 * v)), ri((n,)), ri((8 * n,))]

    def tables_copy():
        return [base[0].clone(), base[1].clone().view(torch.int32),
                base[2].clone(), base[3].clone(), base[4].clone()]

    def slots(t, k=b):
        s = torch.randint(0, t, (k,), generator=gen, dtype=torch.int32)
        s[: k // 4] = torch.randint(0, 64, (k // 4,), generator=gen,
                                    dtype=torch.int32)  # heavy duplicates
        s[5::89] = t          # the sentinel slot: dropped
        s[6::97] = -1         # wraps to the last row
        s[7::101] = -t - 2    # still out of range after one wrap: dropped
        return s.to(dev)

    def active(p=0.7):
        return (torch.rand((b,), generator=gen) < p).to(dev)

    def mask(k):
        return (torch.rand((b, k), generator=gen) < 0.5).to(dev)

    cops = [
        ops.TableOp(0, "add", slots(n), active(), ri((b, 6)), mask(6)),
        ops.TableOp(0, "set", slots(n), active(), ri((b, 6)), mask(6)),
        ops.TableOp(2, "set", slots(n), active(), ri((b, 3 * v))),
        ops.TableOp(0, "set", slots(n), active(), ri((b, 6))),
        ops.TableOp(1, "set", slots(n), active(), ri((b, 6)), mask(6)),
        ops.TableOp(3, "set", slots(n), active(), ri((b,))),
        ops.TableOp(3, "add", slots(n), active(), ri((b,))),
        ops.TableOp(0, "max", slots(n), active(), ri((b, 6))),
        ops.TableOp(4, "set", slots(8 * n), active(), ri((b,))),
        ops.TableOp(2, "set", slots(n), active(), ri((b, 3 * v))),
    ]
    got = ops.fused_table_commit(tables_copy(), cops)
    want = ops.fused_table_commit_reference(tables_copy(), cops)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0.0:
        raise AssertionError(f"table_commit differs from its plain version: {err}")
    nbytes = 0
    for op in cops:
        k = op.vals.shape[1] if op.vals.dim() == 2 else 1
        nbytes += b * (4 + 1 + 4 * k + (k if op.mask is not None else 0))
        lanes = int((op.active[:, None] & (op.mask if op.mask is not None
                                          else torch.ones_like(op.vals, dtype=torch.bool)
                                          .reshape(b, k))).sum())
        nbytes += lanes * 4 * (2 if op.kind != "set" else 1)  # RMW for add/max
    work = tables_copy()
    descs, _keep = ops._commit_descs(work, cops)
    fn, stream = ops._commit_fn(), current_stream()
    plan = ops.commit_plan(work, cops)
    return {
        "name": "fused_table_commit", "route": "cuda",
        "source": "zeebe_tpu_torch/csrc/table_commit.cu",
        "replaces": "zeebe_tpu/tpu/pallas_ops.py:567",
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.fused_table_commit(work, cops)),
        "plain_ms": time_ms(lambda: ops.fused_table_commit_reference(work, cops)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call orders duplicate writes
        "device_us": device_us(lambda: fn(descs, len(cops), stream)),
        "host_us": host_us(lambda: ops.fused_table_commit(work, cops)),
        "device_launches": fn(descs, len(cops), stream),
        "shape": f"{len(cops)} ops in {plan.stages[-1] + 1} stages, B={b}, N={n}, V={v}",
    }


def _filled_map(dev, gen, keys, t=None):
    """A map of ``t`` buckets (by default 8 a key, as ``state.make_state``'s
    element-instance and job maps: 2^19 buckets for 2^16 rows) holding
    ``keys``, a fifth of them deleted again."""
    import torch

    from zeebe_tpu_torch.tpu import hashmap

    n = keys.shape[0]
    if t is None:
        t = 1
        while t < 8 * n:
            t *= 2
    table, ok = hashmap.insert(
        hashmap.make(t, device=dev), keys, torch.arange(n, dtype=torch.int32, device=dev),
        torch.ones(n, dtype=torch.bool, device=dev),
    )
    assert bool(ok.all())
    dead = (torch.rand((n,), generator=gen) < 0.2).to(dev)
    return hashmap.delete(table, keys, dead)


def _lookup_bytes(n, valid) -> int:
    """Flag, found and value per key; per valid key its key and at least
    one bucket (key and value): an invalid key's key is never read."""
    return n * (1 + 1 + 4) + int(valid.sum()) * (8 + 12)


def check_lookup(dev, gen):
    """The element-instance map (T = 2^19 buckets for N = 2^16) probed with
    3B = 3·2^14 keys: hits, misses, tombstones, invalid keys. And the main
    path's case: a config-1 step's two fallback probes (3B keys into the
    element-instance map, B into the job map), ~7.5 % of the keys valid in
    one run, as one ``fused_lookup`` and as two ``lookup`` calls; and
    config 4's five probes as one ``fused_lookup``."""
    import torch

    from zeebe_tpu_torch.tpu import ops, state as state_mod
    from zeebe_tpu_torch.tpu.conditions import VT_NUM

    n = CAP_FACTOR * WAVE
    b = WAVE
    keys = torch.arange(n, dtype=torch.int64, device=dev) * 5 + 1
    table = _filled_map(dev, gen, keys)
    t = table.keys.shape[0]
    pick = torch.randint(0, n, (3 * b,), generator=gen).to(dev)
    q = keys[pick]
    q[::3] += 2**33          # absent keys ≥ 2^32
    q[1::7] = -1             # the EMPTY sentinel as a key
    valid = (torch.rand((3 * b,), generator=gen) < 0.5).to(dev)
    strided = torch.stack([q, q], dim=1)[:, 0]  # a strided key column
    got = list(ops.lookup(table, strided, valid))
    want = list(ops.lookup_reference(table, q, valid))
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0.0:
        raise AssertionError(f"hash_lookup differs from its plain version: {err}")

    # the main path: the fallbacks find almost no key valid (a direct-index
    # hit needs none); the valid ones come in runs (a wave's new keys before
    # the next rebuild), 9 in 10 of them present
    jkeys = torch.arange(n, dtype=torch.int64, device=dev) * 5 + 3
    job = _filled_map(dev, gen, jkeys)
    q_ei = keys[torch.randint(0, n, (3 * b,), generator=gen).to(dev)]
    q_ei[::10] += 2**33
    v_ei = torch.zeros((3 * b,), dtype=torch.bool, device=dev)
    run = round(0.075 * 4 * b)
    v_ei[2 * b: 2 * b + run] = True
    q_job = jkeys[torch.randint(0, n, (b,), generator=gen).to(dev)]
    v_job = torch.zeros((b,), dtype=torch.bool, device=dev)
    pairs = ((table, q_ei, v_ei), (job, q_job, v_job))

    def two():
        return [ops.lookup(m, k, v) for m, k, v in pairs]

    main = {"two_lookups": {"device_us": device_us_calls([two] * 101),
                            "host_us": host_us(two), "launches": 2}}
    probes = [ops.LookupOp(0, q_ei, v_ei), ops.LookupOp(1, q_job, v_job),
              ops.LookupOp(0, strided, valid)]
    want = [r for m, k, v in pairs + ((table, q, valid),)
            for r in ops.lookup_reference(m, k, v)]
    got = [r for pair in ops.fused_lookup([table, job], probes) for r in pair]
    torch.cuda.synchronize()
    fused_err = max_abs_err(got, want)
    if fused_err != 0.0:
        raise AssertionError(f"fused_lookup differs from its plain version: {fused_err}")

    def fused():
        return ops.fused_lookup([table, job], probes[:2])

    main["fused"] = {"device_us": device_us_calls([fused] * 101),
                     "host_us": host_us(fused), "launches": 1}

    # config 4's step: the two fallbacks beside the timer, subscription and
    # stored-message maps' probes, five probes of one launch, into maps of
    # c4_setup's sizes (make_state: 4 buckets a row of the timer and
    # subscription tables, 2 waves each, and of the stored messages', 1)
    # holding what a wave leaves there: a timer and a subscription an
    # instance, a message for half of them; the message maps keyed by
    # correlation composites of the numeric key oid
    c4_maps, c4_probes = [table, job], [ops.LookupOp(0, q_ei, v_ei),
                                        ops.LookupOp(1, q_job, v_job)]
    for rows, t_c4, composite in ((b, 8 * b, False), (b, 8 * b, True), (b // 2, 4 * b, True)):
        held = torch.arange(rows, dtype=torch.int64, device=dev)
        if composite:
            held = state_mod.corr_composite(
                torch.full((rows,), 3, dtype=torch.int32, device=dev),
                torch.full((rows,), VT_NUM, dtype=torch.int32, device=dev),
                held.to(torch.float32).view(torch.int32))
        else:
            held = held * 7 + 2
        q_c4 = held[torch.randint(0, rows, (b,), generator=gen).to(dev)]
        q_c4[::4] += 2**40  # absent: another message name, or a key ≥ 2^40
        c4_probes.append(ops.LookupOp(len(c4_maps), q_c4,
                                      (torch.rand((b,), generator=gen) < 0.5).to(dev)))
        c4_maps.append(_filled_map(dev, gen, held, t=t_c4))
    want = [r for op in c4_probes
            for r in ops.lookup_reference(c4_maps[op.table], op.keys, op.valid)]
    got = [r for pair in ops.fused_lookup(c4_maps, c4_probes) for r in pair]
    torch.cuda.synchronize()
    c4_err = max_abs_err(got, want)
    if c4_err != 0.0:
        raise AssertionError(f"fused_lookup (config 4's five probes) differs from its "
                             f"plain version: {c4_err}")
    fused_err = max(fused_err, c4_err)

    def fused_c4():
        return ops.fused_lookup(c4_maps, c4_probes)

    main["fused_config4"] = {
        "device_us": device_us_calls([fused_c4] * 101), "launches": 1,
        "probes": [int(op.keys.shape[0]) for op in c4_probes],
        "buckets": [int(m.keys.shape[0]) for m in c4_maps],
    }
    main_bytes = _lookup_bytes(3 * b, v_ei) + _lookup_bytes(b, v_job)
    main["bound_us"] = main_bytes / HBM_BYTES_PER_S * 1e6
    main["shape"] = (f"{3 * b} + {b} keys, {int(v_ei.sum()) + int(v_job.sum())} valid "
                     f"in one run, into T={t} and T={job.keys.shape[0]}")

    def one():
        return ops.lookup(table, q, valid)

    return {
        "name": "lookup", "route": "cuda",
        "source": "zeebe_tpu_torch/csrc/hash_lookup.cu",
        "replaces": "zeebe_tpu/tpu/pallas_ops.py:972",
        "max_abs_err": max(err, fused_err),
        "ms": time_ms(one),
        "plain_ms": time_ms(lambda: ops.lookup_reference(table, q, valid)),
        "bound_ms": _lookup_bytes(3 * b, valid) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": None,  # no PyTorch call probes an open-addressing map
        "device_us": device_us_calls([one] * 101), "host_us": host_us(one),
        "device_launches": 1, "main_path": main,
        "shape": f"{3 * b} keys ({int(valid.sum())} valid), T={t}",
    }


# the masked scatters (the sets: one-op commits of csrc/table_commit.cu;
# the adds and maxima: one-op calls of csrc/scatter_accum.cu): per wrapper,
# its kind, the TPU kernel it replaces and the (table shape, dtype,
# lane-masked) cases it is checked at; the first case is the one timed.
# The int64 case goes through lo/hi int32 planes. Shapes are config 3's:
# J = 2^16 join rows, V = 8 variables, B = 2^14 records.
_J = CAP_FACTOR * WAVE
SCATTERS = (
    ("masked_row_update", "set", ":188",
     [((_J, 24), "i32", True), ((_J, 4), "i32", False), ((_J, 8), "i32", False)]),
    ("masked_row_max", "max", ":287", [((_J, 4), "i32", False), ((_J, 8), "i32", False)]),
    ("masked_lane_update", "set", ":431", [((_J,), "i32", False)]),
    ("masked_vec64_update", "set", ":497", [((_J,), "i64", False)]),
    # no path of the port launches masked_row_add (the JAX package reaches it
    # only through its unfused commit chain): checked at the ei_i32 token
    # accumulate's shape. masked_lane_accum runs in the boot self-check
    # ([2^10] int32, B = 2^8: the timed case), and is also checked at the
    # join fan-in's shape
    ("masked_row_add", "add", ":337", [((_J, 6), "i32", True)]),
    ("masked_lane_accum", "add", ":431",
     [((1 << 10,), "i32", False, 1 << 8), ((_J,), "i32", False)]),
)
# the wrappers that are one-op calls of fused_accumulate
ACCUMULATES = ("masked_row_max", "masked_row_add", "masked_lane_accum")


def _scatter_case(dev, gen, shape, dtype, masked, b=WAVE):
    """A table and one batch of records with duplicate, wrapping, sentinel
    and still-out-of-range slots."""
    import torch

    rows = shape[0]
    width = shape[1] if len(shape) == 2 else 1
    lim = 2**40 if dtype == torch.int64 else 2**20
    table = torch.randint(-lim, lim, shape, generator=gen).to(dtype).to(dev)
    vals = torch.randint(-lim, lim, (b,) + tuple(shape[1:]), generator=gen).to(dtype).to(dev)
    s = torch.randint(0, rows, (b,), generator=gen, dtype=torch.int32)
    s[: b // 4] = torch.randint(0, 64, (b // 4,), generator=gen, dtype=torch.int32)
    s[5::89] = rows       # the sentinel slot: dropped
    s[6::97] = -1         # wraps to the last row
    s[7::101] = -rows - 2  # still out of range after one wrap: dropped
    active = (torch.rand((b,), generator=gen) < 0.7).to(dev)
    mask = (torch.rand((b, width), generator=gen) < 0.5).to(dev) if masked else None
    return table, s.to(dev), active, vals, mask


def _written_cells(table, slots, active, mask) -> int:
    """Distinct table elements a scatter writes (the bound's output count)."""
    import torch

    rows = table.shape[0]
    width = table.shape[1] if table.dim() == 2 else 1
    s = slots.to(torch.int64)
    s = torch.where(s < 0, s + rows, s)
    keep = active & (s >= 0) & (s < rows)
    if mask is None:
        return int(torch.unique(s[keep]).numel()) * width
    cells = s[:, None] * width + torch.arange(width, device=s.device)[None, :]
    return int(torch.unique(cells[keep[:, None] & mask]).numel())


def check_scatters(dev, gen):
    """Each masked-scatter wrapper against its plain version at config 3's
    shapes (plus the two wrappers no path launches); one row per wrapper,
    and one for config 3's pair of row maxima in one fused_accumulate."""
    import torch

    from zeebe_tpu_torch.tpu import ops

    out = []
    for name, kind, line, cases in SCATTERS:
        fn = getattr(ops, name)
        err = 0.0
        for shape, dt, masked, *batch in cases:
            dtype = torch.int64 if dt == "i64" else torch.int32
            table, slots, active, vals, mask = _scatter_case(
                dev, gen, shape, dtype, masked, *batch)
            extra = () if mask is None else (mask,)
            got = fn(table.clone(), slots, active, vals, *extra)
            want = ops.masked_scatter_reference(table.clone(), kind, slots, active, vals, mask)
            torch.cuda.synchronize()
            err = max(err, max_abs_err([got], [want]))
        if err != 0.0:
            raise AssertionError(f"{name} differs from its plain version: {err}")
        # the timed case: the first
        shape, dt, masked, *batch = cases[0]
        dtype = torch.int64 if dt == "i64" else torch.int32
        table, slots, active, vals, mask = _scatter_case(
            dev, gen, shape, dtype, masked, *batch)
        extra = () if mask is None else (mask,)
        es = table.element_size()
        width = table.shape[1] if table.dim() == 2 else 1
        b = slots.shape[0]
        cells = _written_cells(table, slots, active, mask)
        # slots (int32 as the path gives them), flags, values, lane mask in;
        # each written element out, and read first by a max or an add
        nbytes = b * (4 + 1 + es * width + (width if mask is not None else 0))
        nbytes += cells * es * (1 if kind == "set" else 2)
        work, plain = table.clone(), table.clone()
        library_ms = None  # no PyTorch call orders duplicate writes (set)
        library = {}  # the library call's device and host time, where it has one
        if kind != "set":
            # one PyTorch call on prepared inputs: dropped records parked on
            # an extra row of a padded copy
            s = slots.to(torch.int64)
            s = torch.where(s < 0, s + shape[0], s)
            idx = torch.where(active & (s >= 0) & (s < shape[0]), s, shape[0])
            pad = torch.cat([table, table[:1]])
            v = vals if mask is None else torch.where(mask, vals, 0)
            if kind == "max":
                idx2 = idx[:, None].expand(-1, width).contiguous()

                def lib():
                    return pad.scatter_reduce_(0, idx2, v, reduce="amax")
            else:
                def lib():
                    return pad.index_add_(0, idx, v)
            library_ms = time_ms(lib)
            library = {"library_device_us": device_us(lambda: (lib(), 0)[1]),
                       "library_host_us": host_us(lib)}
        # the C entry on the wrapper's own arguments (vec64: lo/hi planes)
        keep: list = []
        if name in ACCUMULATES:
            entry = ops._accum_fn()
            call = ops._ACCUM_CALLS[1].pack(current_stream(), 1, *ops._accum_fields(
                name, work, kind, slots, active, vals, mask, keep))

            def launch():
                return entry(call)
        else:
            if dtype == torch.int64:
                d, keep = ops._scatter_desc(name, work.view(torch.int32).view(-1, 2), kind,
                                            slots, active, vals.view(torch.int32).view(-1, 2),
                                            None)
            else:
                d, keep = ops._scatter_desc(name, work, kind, slots, active, vals, mask)
            commit, stream = ops._commit_fn(), current_stream()

            def launch():
                return commit(ctypes.byref(d), 1, stream)
        out.append({
            "name": name, "route": "cuda",
            "source": "zeebe_tpu_torch/csrc/" + (
                "scatter_accum.cu" if name in ACCUMULATES else "table_commit.cu"),
            "replaces": f"zeebe_tpu/tpu/pallas_ops.py{line}",
            "max_abs_err": err,
            "ms": time_ms(lambda: fn(work, slots, active, vals, *extra)),
            "plain_ms": time_ms(lambda: ops.masked_scatter_reference(
                plain, kind, slots, active, vals, mask)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": library_ms,
            "device_us": device_us(launch),
            "host_us": host_us(lambda: fn(work, slots, active, vals, *extra)),
            "device_launches": launch(),
            **library,
            "shape": "; ".join(
                f"[{', '.join(map(str, c[0]))}] {c[1]}{' lane-masked' if c[2] else ''}"
                f", B={c[3] if len(c) > 3 else WAVE}" for c in cases),
        })
    out.append(_accumulate_pair(dev, gen))
    return out


def _per_call_ns(fn, reps: int = 10_000) -> float:
    """Mean host nanoseconds of one call of ``fn`` over ``reps`` calls."""
    for _ in range(100):
        fn()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    return (time.perf_counter_ns() - t0) / reps


def accumulate_host_pieces(dev, gen) -> dict:
    """The one-op row maximum's host work piece by piece, ns a call over
    10^4 calls (``time.perf_counter_ns``, the empty loop's cost taken off),
    at config 3's [J, 4] shape: the accumulate route the wrapper takes,
    beside ``fused_accumulate`` of the same op, and the one-op commit route
    (``ops._scatter``, which the masked sets take and the commutative
    scatters took before ``fused_accumulate``)."""
    import torch

    from zeebe_tpu_torch.tpu import ops

    table, slots, active, vals, _m = _scatter_case(dev, gen, (_J, 4), torch.int32, False)
    name, stream = "masked_row_max", current_stream()
    op = ops.TableOp(0, "max", slots, active, vals)
    fields = ops._accum_fields(name, table, "max", slots, active, vals, None, [])
    call, _keep = ops._accum_call(name, [table], [op], stream, True)
    accum = ops._accum_fn()
    d, _dkeep = ops._scatter_desc(name, table, "max", slots, active, vals, None)
    commit = ops._commit_fn()
    commit_fields = (table.data_ptr(), slots.data_ptr(), active.data_ptr(), vals.data_ptr(), 0,
                     0, 0, table.shape[0], table.shape[1], slots.shape[0], ops._KINDS["max"], 0,
                     0)
    routes = {
        "shared": {
            "_cuda_device": lambda: ops._cuda_device([table, slots, active, vals], name),
            "_device_guard": lambda: _enter_guard(table.device),
            "_stream": current_stream,
            "_count": lambda: ops._count(name, 1),
        },
        "accumulate": {
            "TableOp": lambda: ops.TableOp(0, "max", slots, active, vals),
            "_accum_fields": lambda: ops._accum_fields(name, table, "max", slots, active, vals,
                                                       None, []),
            "pack": lambda: ops._ACCUM_CALLS[1].pack(stream, 1, *fields),
            # the one-op wrapper's packing, and fused_accumulate's for one op
            "_accum_fields + pack": lambda: ops._ACCUM_CALLS[1].pack(
                stream, 1, *ops._accum_fields(name, table, "max", slots, active, vals, None, [])),
            "_accum_call": lambda: ops._accum_call(name, [table], [op], stream, True),
            "C call": lambda: accum(call),
            "wrapper": lambda: ops.masked_row_max(table, slots, active, vals),
            "fused_accumulate, one op": lambda: ops.fused_accumulate([table], [op]),
        },
        "one-op commit": {
            "_check_table": lambda: ops._check_table(table, name),
            "_inputs": lambda: ops._inputs(table.shape[1], slots, active, vals, None, []),
            "pack_into": lambda: ops._COMMIT_LAYOUT.pack_into(d, 0, *commit_fields),
            "ctypes.byref": lambda: ctypes.byref(d),
            "C call": lambda: commit(ctypes.byref(d), 1, stream),
            "wrapper": lambda: ops._scatter(name, table, "max", slots, active, vals),
        },
    }
    empty = _per_call_ns(lambda: None)
    out = {"empty loop": empty}
    for route, pieces in routes.items():
        out[route] = {}
        for label, fn in pieces.items():
            out[route][label] = _per_call_ns(fn) - empty
            torch.cuda.synchronize()
    ops.reset_launches()
    return out


def _accumulate_pair(dev, gen):
    """Config 3's two row maxima (the arrival flags, [J, 4], and the flow-
    position stamps, [J, 8]; one slot and flag per record, B = 2^14) as
    the step issues them: one fused_accumulate, against the plain version
    and, as the yardstick, two scatter_reduce_ calls."""
    import torch

    from zeebe_tpu_torch.tpu import ops

    t1, slots, active, v1, _m = _scatter_case(dev, gen, (_J, 4), torch.int32, False)
    t2 = torch.randint(-2**20, 2**20, (_J, 8), generator=gen).to(torch.int32).to(dev)
    v2 = torch.randint(-2**20, 2**20, (WAVE, 8), generator=gen).to(torch.int32).to(dev)
    pair = [ops.TableOp(0, "max", slots, active, v1), ops.TableOp(1, "max", slots, active, v2)]
    got = ops.fused_accumulate([t1.clone(), t2.clone()], pair)
    want = ops.fused_accumulate_reference([t1.clone(), t2.clone()], pair)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0.0:
        raise AssertionError(f"fused_accumulate differs from its plain version: {err}")
    w1, w2, p1, p2 = t1.clone(), t2.clone(), t1.clone(), t2.clone()
    # slots and flags (read once: the two ops share them), both values in;
    # each written row read and written
    cells = _written_cells(t1, slots, active, None) + _written_cells(t2, slots, active, None)
    nbytes = WAVE * (4 + 1 + 4 * 4 + 4 * 8) + cells * 4 * 2
    s = slots.to(torch.int64)
    s = torch.where(s < 0, s + _J, s)
    idx = torch.where(active & (s >= 0) & (s < _J), s, _J)
    l1, l2 = torch.cat([t1, t1[:1]]), torch.cat([t2, t2[:1]])
    i1, i2 = idx[:, None].expand(-1, 4).contiguous(), idx[:, None].expand(-1, 8).contiguous()

    def lib():
        l1.scatter_reduce_(0, i1, v1, reduce="amax")
        l2.scatter_reduce_(0, i2, v2, reduce="amax")

    def fused():
        return ops.fused_accumulate([w1, w2], pair)

    def two():  # the same pair as two one-op calls
        ops.masked_row_max(w1, slots, active, v1)
        ops.masked_row_max(w2, slots, active, v2)
    entry = ops._accum_fn()
    call, _keep = ops._accum_call("fused_accumulate", [w1, w2], pair, current_stream(), True)
    return {
        "name": "fused_accumulate", "route": "cuda",
        "source": "zeebe_tpu_torch/csrc/scatter_accum.cu",
        "replaces": "zeebe_tpu/tpu/pallas_ops.py:287",
        "max_abs_err": err,
        "ms": time_ms(fused),
        "plain_ms": time_ms(lambda: ops.fused_accumulate_reference([p1, p2], pair)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": time_ms(lib),
        "device_us": device_us(lambda: entry(call)), "host_us": host_us(fused),
        "device_launches": entry(call),
        "library_device_us": device_us_calls([lib] * 101), "library_host_us": host_us(lib),
        "pair": {"two_calls_ms": time_ms(two), "two_calls_host_us": host_us(two),
                 "two_calls_device_us": device_us_calls([two] * 101)},
        "shape": f"config 3's pair: [{_J}, 4] and [{_J}, 8] i32 maxima, B={WAVE}",
    }


def _join_map(dev, gen, b=WAVE):
    """Config 3's join map (2^18 buckets) as a wave finds it: half its
    buckets filled with join-style keys ((scope key << 10) | gateway), a
    fifth of those deleted again (~40% live, ~10% tombstones). Returns
    (map, its preloaded keys, ``b`` further keys none of which it holds)."""
    import torch

    from zeebe_tpu_torch.tpu import hashmap

    t = 4 * CAP_FACTOR * WAVE  # make_state: _pow2(4 * join_capacity)
    scope = torch.randperm(1 << 22, generator=gen)[: t // 2 + b].to(torch.int64)
    keys = (((5 * scope + 1) << 10) | 4).to(dev)
    pre = keys[: t // 2]
    table, _ok = hashmap.insert(
        hashmap.make(t, device=dev), pre,
        torch.arange(pre.shape[0], dtype=torch.int32, device=dev),
        torch.ones(pre.shape[0], dtype=torch.bool, device=dev))
    dead = (torch.rand((pre.shape[0],), generator=gen) < 0.2).to(dev)
    return hashmap.delete(table, pre, dead), pre, keys[t // 2:]


def _copies(table, k):
    from zeebe_tpu_torch.tpu import hashmap

    return [hashmap.HashTable(table.keys.clone(), table.vals.clone()) for _ in range(k)]


def insert_rounds(before, after, ok, valid) -> int:
    """The rounds the plain insert's loop ran, read from its result: every
    pending key advances its probe each round, so a key placed in round r
    sits r buckets past its hash; the loop stops at the first round that
    leaves no key pending, or after MAX_PROBES rounds."""
    import torch

    from zeebe_tpu_torch.tpu import hashmap

    if not bool(valid.any()):
        return 0
    if not bool((ok == valid).all()):
        return hashmap.MAX_PROBES
    t = after.keys.shape[0]
    placed = torch.nonzero(after.keys != before.keys).flatten()
    off = (placed - hashmap._hash(after.keys[placed], t).to(torch.int64)) & (t - 1)
    return int(off.max()) + 1


def _captured_insert(base, keys, vals, valid):
    """The insert captured in a CUDA graph (one cluster launch) and replayed
    once on a copy of ``base``: bit-equal to the plain version. Capture
    runs nothing; a replay reuses its capture's claim epochs, so only the
    first replay is right (ROADMAP Queue 1 item 6)."""
    import torch

    from zeebe_tpu_torch.tpu import hashmap, ops

    warm, work = _copies(base, 2)
    ops.insert(warm, keys, vals, valid)  # built, scratch allocated
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _t, ok = ops.insert(work, keys, vals, valid)
    unchanged = max_abs_err([work.keys, work.vals], [base.keys, base.vals]) == 0.0
    graph.replay()
    want, want_ok = hashmap.insert(base, keys, vals, valid)
    torch.cuda.synchronize()
    err = max_abs_err([work.keys, work.vals, ok.to(torch.int32)],
                      [want.keys, want.vals, want_ok.to(torch.int32)])
    if err != 0.0 or not unchanged:
        raise AssertionError(f"the captured insert differs from its plain version: {err}")
    return {"max_abs_err": err, "replays": 1}


def check_insert(dev, gen):
    """The join map (2^18 buckets) preloaded to ~40% live with tombstones
    mixed in, taking B = 2^14 new keys; and the rebuild shape, 2^16 keys
    into a fresh 2^18-bucket map. Bit-equal buckets, values and ``ok``.
    Timed over fresh copies of the table (a call changes its table), with
    the rounds each case takes, and round 1 of the rebuild shape alone."""
    import torch

    from zeebe_tpu_torch.tpu import hashmap, ops

    b = WAVE
    base, _pre, keys = _join_map(dev, gen, b)
    t = base.keys.shape[0]
    vals = torch.randint(0, CAP_FACTOR * WAVE, (b,), generator=gen, dtype=torch.int32).to(dev)
    valid = (torch.rand((b,), generator=gen) < 0.9).to(dev)
    live = int((base.keys >= 0).sum())
    tomb = int((base.keys == hashmap.TOMBSTONE).sum())

    # the rebuild shape: every element-instance key, three in four live
    n = CAP_FACTOR * WAVE
    rkeys = torch.arange(n, dtype=torch.int64, device=dev) * 5 + 1
    rvals = torch.arange(n, dtype=torch.int32, device=dev)
    rlive = (torch.rand((n,), generator=gen) < 0.75).to(dev)
    fresh = hashmap.make(t, device=dev)

    err = 0.0
    placed, rounds = [], []
    cases = ((base, keys, vals, valid), (fresh, rkeys, rvals, rlive))
    for tbl, k, v, ok_in in cases:
        (got,) = _copies(tbl, 1)
        got, got_ok = ops.insert(got, k, v, ok_in)
        want, want_ok = hashmap.insert(tbl, k, v, ok_in)
        torch.cuda.synchronize()
        err = max(err, max_abs_err([got.keys, got.vals, got_ok.to(torch.int32)],
                                   [want.keys, want.vals, want_ok.to(torch.int32)]))
        placed.append(int(want_ok.sum()))
        rounds.append(insert_rounds(tbl, want, want_ok, ok_in))
    if err != 0.0:
        raise AssertionError(f"insert differs from its plain version: {err}")
    nv = int(valid.sum())
    # flags in and ok out per key; per valid key its key, value and at least
    # one bucket read; per placed key one bucket (key, value) written
    nbytes = b * 2 + nv * (8 + 4 + 8) + placed[0] * 12

    def fresh_calls(tbl, k, v, ok_in, count):
        return [lambda c=c: ops.insert(c, k, v, ok_in) for c in _copies(tbl, count)]

    def one_each(calls):  # time_ms and host_us make 28 calls
        return lambda: calls.pop()()

    timed = {}
    for label, case in (("join", cases[0]), ("rebuild", cases[1])):
        timed[label] = {
            "ms": time_ms(one_each(fresh_calls(*case, 28))),
            "device_us": device_us_calls(fresh_calls(*case, 101)),
            "host_us": host_us(one_each(fresh_calls(*case, 28))),
        }
    rebuild = {**timed["rebuild"], "rounds": rounds[1], "placed": placed[1],
               "plain_ms": time_ms(lambda: hashmap.insert(fresh, rkeys, rvals, rlive))}
    captured = _captured_insert(base, keys, vals, valid)
    # round 1 alone: the C entry told to stop after one round; the argument
    # blocks point into the copies, which live until the calls are done
    entry, stream = ops._insert_fn(), current_stream()
    copies = _copies(fresh, 101)
    blocks = [ops._insert_args(c, rkeys, rvals, rlive, rounds=1) for c in copies]
    rebuild["round1_device_us"] = device_us_calls(
        [lambda a=a: entry(ctypes.byref(a), stream) for a, _ok, _keep in blocks])
    del blocks, copies
    return {
        "name": "insert", "route": "cuda",
        "source": "zeebe_tpu_torch/csrc/hash_update.cu",
        "replaces": "zeebe_tpu/tpu/pallas_ops.py:1043",
        "max_abs_err": err,
        "ms": timed["join"]["ms"],
        "plain_ms": time_ms(lambda: hashmap.insert(base, keys, vals, valid)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,  # no PyTorch call inserts into an open-addressing map
        "device_us": timed["join"]["device_us"], "host_us": timed["join"]["host_us"],
        "device_launches": 1, "rounds": rounds[0], "rebuild": rebuild,
        "captured": captured,
        "shape": f"{b} keys ({nv} valid) into T={t} with {live} live, {tomb} "
                 f"tombstones; rebuild: {n} keys ({int(rlive.sum())} live) into a fresh T={t}",
    }


def _walk_lengths(table, keys, valid):
    """Buckets the plain delete reads for each valid key: up to the first
    bucket that holds the key or is EMPTY, or all MAX_PROBES; 0 for an
    invalid key."""
    import torch

    from zeebe_tpu_torch.tpu import hashmap

    t = table.keys.shape[0]
    h0 = hashmap._hash(keys, t).to(torch.int64)
    length = torch.zeros(keys.shape, dtype=torch.int64, device=keys.device)
    done = ~valid
    for j in range(hashmap.MAX_PROBES):
        k = table.keys[(h0 + j) & (t - 1)]
        stop = ~done & ((k == keys) | (k == hashmap.EMPTY))
        length = torch.where(stop, j + 1, length)
        done = done | stop
    return torch.where(done, length, hashmap.MAX_PROBES)


def _walk_stats(table, keys, valid) -> dict:
    """The plain walk's lengths over the valid keys, and the dependent steps
    the kernel's warps take for them: a warp's 32 keys walk side by side,
    the first ZB_DELETE_GROUP buckets of each in one step and the rest in
    a second, so a warp takes 1 step where its longest walk L is at most
    G, else 2."""
    import torch

    from zeebe_tpu_torch.tpu import ops

    length = _walk_lengths(table, keys, valid)
    lv = length[valid].to(torch.float64)
    g = ops._DELETE_GROUP
    pad = (-keys.shape[0]) % 32
    per_warp = torch.nn.functional.pad(length, (0, pad)).view(-1, 32).amax(dim=1)
    steps = 1 + (per_warp > g).to(torch.int64)
    walking = steps[per_warp > 0].to(torch.float64)
    return {
        "mean": float(lv.mean()), "p50": float(lv.quantile(0.5)),
        "p99": float(lv.quantile(0.99)), "max": int(lv.max()),
        "over_8": float((lv > 8).to(torch.float64).mean()),
        "over_16": float((lv > 16).to(torch.float64).mean()),
        "group": g, "warps": int(per_warp.shape[0]), "warps_walking": int(walking.numel()),
        "warp_steps_mean": float(walking.mean()), "warp_steps_max": int(walking.max()),
    }


def _keys_to_delete(dev, gen, held, absent, b=WAVE):
    """``b`` keys: half drawn from ``held`` (distinct; some of them deleted
    already), half from ``absent``; about 90 % valid."""
    import torch

    pick = torch.randperm(held.shape[0], generator=gen)[: b // 2].to(dev)
    keys = torch.cat([held[pick], absent[: b - b // 2]])
    valid = (torch.rand((b,), generator=gen) < 0.9).to(dev)
    return keys, valid


def _wrap_case(dev):
    """A map of 2^10 buckets holding 28 keys whose hash lands in its last 4
    buckets, so their chains wrap past T - 1; delete 14 of them and 10
    keys hashed there that it does not hold (chains of up to 32 buckets),
    with 4 more held keys invalid."""
    import torch

    from zeebe_tpu_torch.tpu import hashmap

    t = 1 << 10
    cand = torch.arange(1, 1 << 20, dtype=torch.int64, device=dev) * 7 + 3
    near = cand[hashmap._hash(cand, t) >= t - 4][:38]
    held = near[:28]
    table, ok = hashmap.insert(hashmap.make(t, device=dev), held,
                               torch.arange(28, dtype=torch.int32, device=dev),
                               torch.ones(28, dtype=torch.bool, device=dev))
    assert bool(ok.all())
    assert bool((torch.nonzero(table.keys >= 0).flatten() < 32).any()), "no chain wrapped"
    keys = torch.cat([held[:14], near[28:38], held[14:18]])
    valid = torch.ones(keys.shape, dtype=torch.bool, device=dev)
    valid[24:] = False
    return table, keys, valid


def _run_out_case(dev):
    """A full map of 2^10 buckets (no EMPTY, some tombstones): one key
    held in the 32nd bucket of its chain (deleted), one in the 33rd (out
    of reach: nothing written) and one absent key (its 32 buckets read to
    the end)."""
    import torch

    from zeebe_tpu_torch.tpu import hashmap

    t = 1 << 10
    tkeys = torch.arange(t, dtype=torch.int64, device=dev) + 10**9
    tkeys[::37] = hashmap.TOMBSTONE
    keys = torch.tensor([11, 12, 13], dtype=torch.int64, device=dev)
    h = hashmap._hash(keys, t).tolist()
    at = ((h[0] + 31) % t, (h[1] + 32) % t)
    assert at[0] != at[1]
    tkeys[at[0]] = keys[0]
    tkeys[at[1]] = keys[1]
    table = hashmap.HashTable(tkeys, torch.arange(t, dtype=torch.int32, device=dev))
    return table, keys, torch.ones(3, dtype=torch.bool, device=dev)


def _fused_cases(dev, gen, join):
    """The step's two deletes (the timer map, 2^15 buckets a quarter live,
    and the join map) and the demotion's four (the element-instance and
    job maps, 2^19 buckets, the timer and join maps): B = 2^14 keys each,
    half held, about 90 % valid. Returns (label, tables, DeleteOps)."""
    import torch

    from zeebe_tpu_torch.tpu import hashmap, ops

    b = WAVE
    jmap, jpre, jabsent = join
    n_t = CAP_FACTOR * WAVE // 8  # make_state: timer capacity // 8, map 4x
    tkeys = (torch.randperm(1 << 20, generator=gen)[: 2 * n_t].to(torch.int64) * 3 + 1).to(dev)
    tmap, ok = hashmap.insert(hashmap.make(4 * n_t, device=dev), tkeys[:n_t],
                              torch.arange(n_t, dtype=torch.int32, device=dev),
                              torch.ones(n_t, dtype=torch.bool, device=dev))
    assert bool(ok.all())
    tmap = hashmap.delete(tmap, tkeys[:n_t], (torch.rand((n_t,), generator=gen) < 0.2).to(dev))
    n = CAP_FACTOR * WAVE
    ei_keys = torch.arange(n, dtype=torch.int64, device=dev) * 5 + 1
    job_keys = torch.arange(n, dtype=torch.int64, device=dev) * 5 + 3
    ei, job = _filled_map(dev, gen, ei_keys), _filled_map(dev, gen, job_keys)
    t_del = _keys_to_delete(dev, gen, tkeys[:n_t], tkeys[n_t:], b)
    j_del = _keys_to_delete(dev, gen, jpre, jabsent, b)
    e_del = _keys_to_delete(dev, gen, ei_keys, ei_keys + 2**33, b)
    b_del = _keys_to_delete(dev, gen, job_keys, job_keys + 2**33, b)
    return [
        ("fused_2", [tmap, jmap], [ops.DeleteOp(0, *t_del), ops.DeleteOp(1, *j_del)]),
        ("fused_4", [ei, job, tmap, jmap],
         [ops.DeleteOp(0, *e_del), ops.DeleteOp(1, *b_del), ops.DeleteOp(2, *t_del),
          ops.DeleteOp(3, *j_del)]),
    ]


def _copies_of(tables, k):
    return [_copies(t, k) for t in tables]


def check_delete(dev, gen):
    """B = 2^14 keys, half of them held, out of the ~40%-live join map,
    with the plain walk's lengths; a map whose chains wrap past T - 1 and
    a full map whose chains run out, bit-equal; and the step's two deletes
    (timer and join maps) and the demotion's four as one ``fused_delete``
    each, bit-equal to the plain deletes one after another, one launch."""
    import torch

    from zeebe_tpu_torch.tpu import hashmap, ops

    b = WAVE
    base, pre, absent = _join_map(dev, gen, b)
    t = base.keys.shape[0]
    keys, valid = _keys_to_delete(dev, gen, pre, absent, b)
    err = 0.0
    for tbl, k, v in ((base, keys, valid), _wrap_case(dev), _run_out_case(dev)):
        (got,) = _copies(tbl, 1)
        got = ops.delete(got, k, v)
        want = hashmap.delete(tbl, k, v)
        torch.cuda.synchronize()
        err = max(err, max_abs_err([got.keys, got.vals], [want.keys, want.vals]))
    if err != 0.0:
        raise AssertionError(f"delete differs from its plain version: {err}")
    nv = int(valid.sum())
    deleted = int((hashmap.delete(base, keys, valid).keys != base.keys).sum())
    # flags in; per valid key its key and at least one bucket read; per
    # deleted key one tombstone written
    nbytes = b + nv * (8 + 8) + deleted * 8

    def fresh_calls(count):
        return [lambda c=c: ops.delete(c, keys, valid) for c in _copies(base, count)]

    def one_each(calls):  # time_ms and host_us make 28 calls
        return lambda: calls.pop()()

    fused = {}
    for label, tables, deletes in _fused_cases(dev, gen, (base, pre, absent)):
        got = [c[0] for c in _copies_of(tables, 1)]
        before = ops.DEVICE_LAUNCHES["delete"]
        ops.fused_delete(got, deletes)
        launches = ops.DEVICE_LAUNCHES["delete"] - before
        want = [_copies(t, 1)[0] for t in tables]
        for op in deletes:
            want[op.table] = hashmap.delete(want[op.table], op.keys, op.valid)
        torch.cuda.synchronize()
        ferr = max_abs_err([x for g in got for x in (g.keys, g.vals)],
                           [x for w in want for x in (w.keys, w.vals)])
        if ferr != 0.0 or launches != 1:
            raise AssertionError(f"{label}: fused_delete differs from the plain deletes "
                                 f"one after another ({ferr}) or took {launches} launches")
        err = max(err, ferr)
        sets = list(zip(*_copies_of(tables, 101)))
        fused[label] = {
            "ops": len(deletes), "device_launches": launches, "max_abs_err": ferr,
            "device_us": device_us_calls(
                [lambda c=c: ops.fused_delete(list(c), deletes) for c in sets]),
            "valid": [int(op.valid.sum()) for op in deletes],
        }
        del sets
    return {
        "name": "delete", "route": "cuda",
        "source": "zeebe_tpu_torch/csrc/hash_update.cu",
        "replaces": "zeebe_tpu/tpu/pallas_ops.py:1130",
        "max_abs_err": err,
        "ms": time_ms(one_each(fresh_calls(28))),
        "plain_ms": time_ms(lambda: hashmap.delete(base, keys, valid)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,  # no PyTorch call deletes from an open-addressing map
        "device_us": device_us_calls(fresh_calls(101)),
        "host_us": host_us(one_each(fresh_calls(28))), "device_launches": 1,
        "walk": _walk_stats(base, keys, valid), "fused": fused,
        "shape": f"{b} keys ({nv} valid, {deleted} deleted) out of T={t}; "
                 "wrap-around and run-out maps of T=1024",
    }


def check_row_loop(dev, gen):
    """The probe's row loop at its own sizes (B = 2^14 random indices into
    CAP = 2^16 rows of K = 128 int32: about 1,700 rows named more than
    once), n_writes 1 and 10, from a random table: bit-equal in place.
    Device µs also at n_writes 10 and for each pass alone (the write pass
    on the claims its epoch's claim pass left)."""
    import torch

    from zeebe_tpu_torch import probe
    from zeebe_tpu_torch.tpu import ops

    b, cap, k = probe.B, probe.CAP, probe.K
    base = torch.randint(-2**31, 2**31 - 1, (cap, k), generator=gen,
                         dtype=torch.int64).to(torch.int32).to(dev)
    idx = torch.randint(0, cap, (b,), generator=gen, dtype=torch.int32).to(dev)
    rows = torch.randint(-2**31, 2**31 - 1, (b, k), generator=gen,
                         dtype=torch.int64).to(torch.int32).to(dev)
    err = 0.0
    for n in (1, 10):
        got = probe.row_loop(base.clone(), idx, rows, n)
        want = probe.row_loop_reference(base.clone(), idx, rows, n)
        torch.cuda.synchronize()
        err = max(err, max_abs_err([got], [want]))
    if err != 0.0:
        raise AssertionError(f"row_loop differs from its plain version: {err}")
    distinct = int(torch.unique(idx).numel())
    # the indices, the winners' rows in, the written rows out
    nbytes = b * 4 + 2 * distinct * k * 4
    work, plain, lib = base.clone(), base.clone(), base.clone()
    passes_us = {"both_w10": device_us_calls([lambda: probe.row_loop(work, idx, rows, 10)] * 101)}
    # each pass alone, on an epoch newer than every tag in the scratch: the
    # write pass reads the claims the claim pass left
    fn, stream = probe._row_loop_fn(), current_stream()
    scratch, epoch = ops._claim_scratch(work.device, cap, 1)

    def passes(n_writes, which):
        return lambda: fn(work.data_ptr(), idx.data_ptr(), rows.data_ptr(), b, cap, k,
                          n_writes, scratch.data_ptr(), epoch, which, stream)
    passes_us.update(claim=device_us(passes(1, 1)), write=device_us(passes(1, 2)),
                     write_w10=device_us(passes(10, 2)))
    return {
        "name": "row_loop", "route": "cuda",
        "source": "zeebe_tpu_torch/csrc/probe.cu",
        "replaces": "benchmarks/pallas_probe.py:62",
        "max_abs_err": err,
        "ms": time_ms(lambda: probe.row_loop(work, idx, rows, 1)),
        "ms_w10": time_ms(lambda: probe.row_loop(work, idx, rows, 10)),
        "plain_ms": time_ms(lambda: probe.row_loop_reference(plain, idx, rows, 1)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        # one index_put_ row scatter (it orders no duplicates: timed only)
        "library_ms": time_ms(lambda: probe.index_put_chain(lib, idx, rows, 1)),
        # the profiler records no device time for a window of ctypes kernels
        # alone (§7 of PERF.md): CUDA events around calls back to back
        "device_us": device_us_calls([lambda: probe.row_loop(work, idx, rows, 1)] * 101),
        "host_us": host_us(lambda: probe.row_loop(work, idx, rows, 1)),
        "device_launches": 2,
        "passes_us": passes_us,
        "shape": f"B={b} into [{cap}, {k}] i32 ({b - distinct} repeats), n_writes 1 and 10",
    }


def _probe_cases(dev, gen):
    """The probe's two tables with B = 2^14 keys each: the script's own
    (key k at index k for every third k: keys away from their hash) and a
    half-full table filled by the probe's hash with linear probing (half
    the keys present)."""
    import numpy as np
    import torch

    from zeebe_tpu_torch import probe

    b, cap = probe.B, probe.CAP
    keys = torch.randint(0, cap, (b,), generator=gen, dtype=torch.int32).to(dev)
    rng = np.random.default_rng(int(torch.randint(0, 2**31, (1,), generator=gen)))
    present = rng.choice(2**31 - 1, cap // 2, replace=False)
    mixed = np.concatenate([rng.choice(present, b // 2),
                            rng.integers(-2**31, 0, size=b // 2)]).astype(np.int32)
    return [
        ("script table", keys, probe.script_table(cap).to(dev)),
        ("hashed table", torch.from_numpy(mixed).to(dev),
         torch.from_numpy(probe.hashed_table(present, cap)).to(dev)),
    ]


def _probe_reads(keys, tkeys) -> int:
    """Table buckets the probe of ``keys`` reads (this data's chains)."""
    import torch

    from zeebe_tpu_torch import probe

    cap = tkeys.shape[0]
    h = probe._home(keys, cap)
    done = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    reads = 0
    for j in range(probe.PROBES):
        tk = tkeys[(h + j) & (cap - 1)]
        reads += int((~done).sum())
        done = done | (tk == keys) | (tk == probe.EMPTY)
    return reads


def check_probe(dev, gen):
    """The probe on both tables: bit-equal slots; timed on the hashed
    table (the script's table is almost all first-probe misses)."""
    import torch

    from zeebe_tpu_torch import probe

    cases = _probe_cases(dev, gen)
    err = 0.0
    hits = {}
    for name, keys, tkeys in cases:
        got = probe.probe(keys, tkeys)
        want = probe.probe_reference(keys, tkeys)
        torch.cuda.synchronize()
        err = max(err, max_abs_err([got], [want]))
        hits[name] = int((want >= 0).sum())
    if err != 0.0:
        raise AssertionError(f"probe differs from its plain version: {err}")
    (_, script_keys, script_table), (_, keys, tkeys) = cases
    b = keys.shape[0]
    # keys in, slots out, one 4-byte bucket per probe step this data takes
    nbytes = b * 8 + _probe_reads(keys, tkeys) * 4
    return {
        "name": "probe", "route": "cuda",
        "source": "zeebe_tpu_torch/csrc/probe.cu",
        "replaces": "benchmarks/pallas_probe.py:116",
        "max_abs_err": err,
        "ms": time_ms(lambda: probe.probe(keys, tkeys)),
        "ms_script_table": time_ms(lambda: probe.probe(script_keys, script_table)),
        "plain_ms": time_ms(lambda: probe.probe_reference(keys, tkeys)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,  # no PyTorch call probes a linear-probe table
        "device_us": device_us_calls([lambda: probe.probe(keys, tkeys)] * 101),
        "host_us": host_us(lambda: probe.probe(keys, tkeys)), "device_launches": 1,
        "shape": f"B={b} keys into T={tkeys.shape[0]} i32; hits {hits}",
    }


# the two-thread case: table commits and inserts a thread, as a cluster
# node's drain actors issue them (one per broker)
THREAD_COMMITS = 1000
THREAD_INSERTS = 100


def _thread_calls(dev, gen):
    """One thread's tables and calls: a [4096, 8] table and a [4096] one
    under set-heavy commits (B = 1024, a quarter of the slots in 16 rows),
    and a map of 2^15 buckets under inserts of 128 fresh keys each."""
    import torch

    from zeebe_tpu_torch.tpu import hashmap, ops

    n, b = 4096, 1024

    def ri(shape):
        return torch.randint(-1000, 1000, shape, generator=gen, dtype=torch.int32).to(dev)

    def slots():
        s = torch.randint(0, n, (b,), generator=gen, dtype=torch.int32)
        s[: b // 4] = torch.randint(0, 16, (b // 4,), generator=gen, dtype=torch.int32)
        return s.to(dev)

    def active():
        return (torch.rand((b,), generator=gen) < 0.8).to(dev)

    tables = [ri((n, 8)), ri((n,))]
    commits = [[ops.TableOp(0, "set", slots(), active(), ri((b, 8))),
                ops.TableOp(0, "add", slots(), active(), ri((b, 8))),
                ops.TableOp(1, "set", slots(), active(), ri((b,))),
                ops.TableOp(0, "set", slots(), active(), ri((b, 8)),
                            (torch.rand((b, 8), generator=gen) < 0.5).to(dev))]
               for _ in range(THREAD_COMMITS)]
    keys = torch.randperm(1 << 20, generator=gen)[: 128 * THREAD_INSERTS].to(dev) + 1
    inserts = [(keys[128 * i: 128 * (i + 1)], (keys[128 * i: 128 * (i + 1)] % 997)
                .to(torch.int32), torch.ones(128, dtype=torch.bool, device=dev))
               for i in range(THREAD_INSERTS)]
    return tables, hashmap.make(1 << 15, device=dev), commits, inserts


def _run_thread_calls(tables, table, commits, inserts):
    from zeebe_tpu_torch.tpu import ops

    every = THREAD_COMMITS // THREAD_INSERTS
    for k, cops in enumerate(commits):
        ops.fused_table_commit(tables, cops)
        if k % every == every - 1:
            ops.insert(table, *inserts[k // every])


def check_two_threads(dev):
    """Two threads, each with tables of its own, run THREAD_COMMITS table
    commits and THREAD_INSERTS inserts at once on one card; every table
    ends bit-equal to the same calls run one thread after the other. The
    claim scratch is shared: an epoch launched after a higher one on the
    same claim words would lose its writes (ops._claims)."""
    import threading

    import torch

    serial, threaded = ([_thread_calls(dev, torch.Generator().manual_seed(77 + t))
                         for t in range(2)] for _ in range(2))
    t0 = time.perf_counter()
    for tables, table, commits, inserts in serial:
        _run_thread_calls(tables, table, commits, inserts)
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    errors = []

    def run(calls):
        try:
            _run_thread_calls(*calls)
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads between any two calls
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(calls,)) for calls in threaded]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        torch.cuda.synchronize()
        threaded_s = time.perf_counter() - t0
    finally:
        sys.setswitchinterval(switch)
    if any(t.is_alive() for t in threads) or errors:
        raise AssertionError(f"two-thread case: {errors or 'a thread did not finish'}")
    for t, (a, b) in enumerate(zip(serial, threaded)):
        for name, x, y in (("table", a[0][0], b[0][0]), ("lane table", a[0][1], b[0][1]),
                           ("map keys", a[1].keys, b[1].keys),
                           ("map vals", a[1].vals, b[1].vals)):
            if not torch.equal(x, y):
                cells = int((x != y).sum())
                raise AssertionError(
                    f"two-thread case: thread {t}'s {name} differs from the serial "
                    f"run in {cells} cells")
    return {"commits": 2 * THREAD_COMMITS, "inserts": 2 * THREAD_INSERTS,
            "serial_seconds": serial_s, "threaded_seconds": threaded_s}


# ---------------------------------------------------------------------------
# phase 3: the whole path on the card against the same path on the CPU
# ---------------------------------------------------------------------------


# the wrappers each main path must launch (the lookup-state rebuild
# inserts through the insert kernel on both paths)
CONFIG1_KERNELS = ("fused_gather_rows", "fused_table_commit", "lookup", "insert")
CONFIG3_KERNELS = CONFIG1_KERNELS + (
    "masked_row_update", "fused_accumulate", "masked_lane_update",
    "masked_vec64_update", "delete",
)
TIMER_KERNELS = CONFIG1_KERNELS + ("delete",)
CONFIG4_KERNELS = TIMER_KERNELS
CONFIG5_KERNELS = CONFIG1_KERNELS
PROBE_KERNELS = ("row_loop", "probe")
# exact launches of a drive: per round of the step, per tick and per
# lookup-state rebuild (one insert for each of the six maps); configs 2 and
# 5 run config 1's kernels (the condition programs are plain PyTorch). A
# step's fallback probes are one fused lookup; config 3 adds the join
# path's two, and its two row maxima are one fused accumulate. Config 4's
# round: the timer, subscription and stored-message maps' probes join the
# fused lookup, and the boundary path's job-map probe (keys from a
# gathered row) is a second lookup launch; one commit each for the
# element-instance, job and timer tables and the two message stores; an
# insert into each of the three maps; their deletes one fused delete. A
# tick is one gather
PER_ROUND = {
    "config1": {"fused_gather_rows": 8, "fused_table_commit": 2, "lookup": 1},
    "config3": {"fused_gather_rows": 8, "fused_table_commit": 2, "lookup": 3,
                "masked_row_update": 3, "fused_accumulate": 1, "masked_lane_update": 2,
                "masked_vec64_update": 2, "insert": 1, "delete": 1},
    "config4": {"fused_gather_rows": 8, "fused_table_commit": 5, "lookup": 2,
                "insert": 3, "delete": 1},
}
PER_ROUND["config2"] = PER_ROUND["config5"] = PER_ROUND["config1"]
PER_TICK = {"config4": {"fused_gather_rows": 1}}
INSERTS_PER_REBUILD = 6
# device launches of the table commits a round: an element-instance commit
# is 3 (the token adds' pass, the sets' claim and write passes), a commit of
# sets only 2 (the job, timer and message-store commits); no commit of any
# path takes more than 3
COMMIT_DEVICE_PER_ROUND = {"config1": 5, "config2": 5, "config3": 5, "config4": 11,
                           "config5": 5}
COMMIT_DEVICE_MAX = 3


def reset_launches() -> None:
    from zeebe_tpu_torch import probe
    from zeebe_tpu_torch.tpu import ops

    ops.reset_launches()
    probe.reset_launches()


def launch_counts() -> dict:
    """Every wrapper's launches since the last reset: the 12 of ``ops``
    and the 2 of ``probe``."""
    from zeebe_tpu_torch import probe
    from zeebe_tpu_torch.tpu import ops

    return {**ops.LAUNCHES, **probe.LAUNCHES}


def commit_device_launches(label) -> dict:
    """The device kernels the table commits enqueued since the last reset,
    beside their wrapper calls; no commit may take more than
    COMMIT_DEVICE_MAX launches (the main path's take 3, 2 and 2)."""
    from zeebe_tpu_torch.tpu import ops

    calls = ops.LAUNCHES["fused_table_commit"]
    device = ops.DEVICE_LAUNCHES["fused_table_commit"]
    if device > COMMIT_DEVICE_MAX * calls:
        raise AssertionError(f"{label}: {device} commit launches for {calls} commits")
    return {"calls": calls, "device": device, "all": dict(ops.DEVICE_LAUNCHES)}


def drive_path(label, drive, instances, wave, per_instance, path):
    """One config at the benchmark's width on the card through ``drive``
    (``drive_config`` or a config's own), the launch counters zeroed just
    before and read just after: every instance completed, ``per_instance``
    records processed per instance, no overflow (the drive loop raises on
    one), every kernel of ``path`` launched, and each wrapper launched
    exactly as often as the rounds, ticks and rebuilds ask."""
    import torch

    waves = instances // wave
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    _state, totals, elapsed = drive(waves, wave, "cuda")
    launches = launch_counts()
    if totals["completed_roots"] != instances:
        raise AssertionError(f"completed {totals['completed_roots']} != {instances}")
    if totals["processed"] != per_instance * instances:
        raise AssertionError(f"processed {totals['processed']} != {per_instance} x {instances}")
    zero = [k for k in path if launches[k] <= 0]
    if zero:
        raise AssertionError(f"kernels never launched on the main path: {zero}")
    rebuilds = len(range(0, waves, REBUILD_EVERY))
    want = {k: 0 for k in launches}
    for k, n in PER_ROUND[label].items():
        want[k] = n * totals["rounds"]
    for k, n in PER_TICK.get(label, {}).items():
        want[k] += n * totals["ticks"]
    want["insert"] += INSERTS_PER_REBUILD * rebuilds
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} != {want} "
                             f"({totals['rounds']} rounds, {rebuilds} rebuilds)")
    commits = commit_device_launches(label)
    if commits["device"] != COMMIT_DEVICE_PER_ROUND[label] * totals["rounds"]:
        raise AssertionError(f"{label}: {commits['device']} commit launches in "
                             f"{totals['rounds']} rounds")
    timed = int((waves - 1) * wave * per_instance)
    return {
        "waves": waves, "wave": wave, "instances": instances,
        "totals": totals, "timed_seconds": elapsed, "timed_transitions": timed,
        "transitions_per_sec": timed / elapsed if elapsed > 0 else float("nan"),
        "launches": launches, "commit_launches": commits,
        "peak_bytes": torch.cuda.max_memory_allocated(),
    }


def parity(wave=1024, waves=3, model_fn=config1_model,
           per_instance=TRANSITIONS_PER_INSTANCE, rebuild_every=REBUILD_EVERY,
           mixed=False, per_stopped=0, drive=None):
    """Drive a config on the card and on the CPU (``drive_config`` with
    ``model_fn``, or ``drive``): bit-equal state and totals,
    ``per_instance`` records per instance (``per_stopped`` for the
    instances ``mixed`` leaves without orderValue)."""
    import numpy as np

    from zeebe_tpu_torch.tpu import state as state_mod

    results = {}
    for device in ("cuda", "cpu"):
        if drive is None:
            st, totals, _ = drive_config(waves, wave, device, model_fn=model_fn,
                                         rebuild_every=rebuild_every, mixed=mixed)
        else:
            st, totals, _ = drive(waves, wave, device, rebuild_every=rebuild_every)
        results[device] = (state_mod.state_to_numpy(st), totals)
    (a, ta), (c, tc) = results["cuda"], results["cpu"]
    if ta != tc:
        raise AssertionError(f"totals differ: cuda {ta} cpu {tc}")
    bad = [k for k in a if a[k].dtype != c[k].dtype or a[k].shape != c[k].shape
           or not np.array_equal(a[k], c[k])]
    if bad:
        raise AssertionError(f"state differs between cuda and cpu: {bad}")
    stopped = int(mixed_order_values(wave)[1].sum()) if mixed else 0
    want = int(waves * (per_instance * (wave - stopped) + per_stopped * stopped))
    if ta["processed"] != want or ta["completed_roots"] != waves * (wave - stopped):
        raise AssertionError(f"totals {ta}: processed != {want} or completed != "
                             f"{waves * (wave - stopped)}")
    return ta


def parity_c4_wave(wave=WAVE):
    """One config-4 wave at full width (``c4_wave`` at ``c4_setup``'s
    capacities) on the card and on the CPU: the step's five-probe fused
    lookup, the two message-store commits and the fused delete at the main
    path's shapes, held to their plain versions through the state they
    leave. Bit-equal state (the maps as the wave's deletes left them, before
    any rebuild) and each drive's totals."""
    import numpy as np

    from zeebe_tpu_torch.tpu import state as state_mod

    results = {}
    for device in ("cuda", "cpu"):
        graph, st, queue, meta = c4_setup(wave, device)
        st, _queue, parts = c4_wave(graph, meta, st, queue, wave, 0, device)
        results[device] = (state_mod.state_to_numpy(st), parts)
    (a, pa), (c, pc) = results["cuda"], results["cpu"]
    if pa != pc:
        raise AssertionError(f"config 4 wave: drive totals differ: cuda {pa} cpu {pc}")
    bad = [k for k in a if a[k].dtype != c[k].dtype or a[k].shape != c[k].shape
           or not np.array_equal(a[k], c[k])]
    if bad:
        raise AssertionError(f"config 4 wave: state differs between cuda and cpu: {bad}")
    return pa


def mixed_case(rng, capacity, size, num_vars=8):
    """numpy arrays of a state with live process/task instances and jobs in
    every job state, and a batch mixing job commands (stale keys, bad
    retries, several commands on one job), job events, timer commands,
    CREATEs and workflow-instance events, with NaN payload bits: the paths
    of the step that config 1's happy path never takes."""
    import numpy as np

    from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
    from zeebe_tpu_torch.protocol.intents import JobIntent, TimerIntent
    from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI
    from zeebe_tpu_torch.tpu import batch as rb, state as state_mod

    st = state_mod.state_to_numpy(
        state_mod.make_state(capacity=capacity, num_vars=num_vars, device="cpu"))
    n = capacity // 8
    proc = 10 * np.arange(n, dtype=np.int64) + 1
    task, jobk = proc + 5, 5 * np.arange(n, dtype=np.int64) + 2
    st["ei_i32"][0:2 * n:2] = [0, int(WI.ELEMENT_ACTIVATED), 0, -1, 1, -1]
    st["ei_i32"][1:2 * n:2] = [3, int(WI.ELEMENT_ACTIVATED), 0, 0, 0, -1]
    st["ei_i32"][1:2 * n:2, 3] = np.arange(0, 2 * n, 2)
    st["ei_i64"][0:2 * n:2] = np.stack([proc, proc, np.full(n, -1)], axis=1)
    st["ei_i64"][1:2 * n:2] = np.stack([task, proc, jobk], axis=1)
    jstates = np.array([int(JobIntent.CREATED), int(JobIntent.ACTIVATED),
                        int(JobIntent.FAILED), int(JobIntent.TIMED_OUT)])
    st["job_i32"][:n] = np.stack([jstates[np.arange(n) % 4], np.full(n, 3), np.zeros(n),
                                  1 + np.arange(n) % 2, np.arange(n) % 3,
                                  np.full(n, 7)], axis=1)
    st["job_i64"][:n] = np.stack([jobk, proc, task, 1000 + np.arange(n)], axis=1)
    st["ei_pay"][:] = rng.integers(-2**31, 2**31 - 1, size=st["ei_pay"].shape)
    st["job_pay"][:] = rng.integers(-2**31, 2**31 - 1, size=st["job_pay"].shape)
    st["sub_key"][:3], st["sub_type"][:3] = [11, 12, 13], [1, 2, 1]
    st["sub_credits"][:3], st["sub_timeout"][:3] = [5, 3, 1000], [300, 400, 500]
    st["sub_valid"][:3] = [True, True, False]
    st["next_wf_key"] = np.array(20 * n + 1, np.int64)
    st["next_job_key"] = np.array(10 * n + 2, np.int64)
    st = state_mod.state_to_numpy(
        state_mod.rebuild_lookup_state(state_mod.state_from_numpy(st, device="cpu")))

    b = size
    cols = rb.batch_to_numpy(rb.empty(b, num_vars, device="cpu"))
    kind = rng.integers(0, 6, size=b)  # job cmd, job event, timer cmd, CREATE, WI event x2
    pick = rng.integers(0, n, size=b)
    cols["valid"] = rng.random(b) < 0.9
    cols["rtype"][:] = np.where(np.isin(kind, [1, 4, 5]), int(RecordType.EVENT),
                                int(RecordType.COMMAND))
    cols["vtype"][:] = np.select([kind <= 1, kind == 2],
                                 [int(ValueType.JOB), int(ValueType.TIMER)],
                                 int(ValueType.WORKFLOW_INSTANCE))
    cols["intent"][:] = np.select(
        [kind <= 1, kind == 2, kind == 3],
        [rng.choice([int(i) for i in JobIntent], size=b),
         rng.choice([int(TimerIntent.CREATE), int(TimerIntent.TRIGGER),
                     int(TimerIntent.CANCEL)], size=b), int(WI.CREATE)],
        rng.integers(0, 17, size=b))
    cols["key"][:] = np.select(
        [rng.random(b) < 0.2, kind <= 2, kind >= 4],
        [5 * rng.integers(10**6, 2 * 10**6, size=b) + 2, jobk[pick],
         np.where(rng.random(b) < 0.5, proc[pick], task[pick])], -1)
    cols["key"][:8] = jobk[0]
    cols["elem"][:] = np.where(kind >= 4, rng.integers(-1, 5, size=b), 3)
    cols["wf"][:] = np.where(rng.random(b) < 0.95, 0, -1)
    cols["instance_key"][:] = proc[pick]
    cols["scope_key"][:] = np.where(rng.random(b) < 0.7, proc[pick], -1)
    cols["aux_key"][:] = np.where(rng.random(b) < 0.9, task[pick], -1)
    cols["type_id"][:] = rng.integers(0, 3, size=b)
    cols["retries"][:] = rng.integers(-1, 3, size=b)
    cols["deadline"][:] = rng.integers(0, 10**6, size=b)
    cols["worker"][:] = rng.integers(0, 30, size=b)
    cols["req"][:] = np.where(rng.random(b) < 0.5, rng.integers(0, 10**9, size=b), -1)
    cols["req_stream"][:] = rng.choice([11, 12, 13, 99, -1], size=b)
    cols["v_vt"][:] = rng.integers(0, 6, size=(b, num_vars))
    cols["v_num"].view(np.int32)[:] = rng.integers(-2**31, 2**31 - 1, size=(b, num_vars))
    cols["v_str"][:] = rng.integers(0, 50, size=(b, num_vars))
    return st, cols


def parity_mixed(capacity=8192, size=4096, seed=7):
    """One step of the mixed batch on the card and on the CPU (B > 2048:
    the large-batch branches): state, emissions and stats bit-equal."""
    import numpy as np

    st, cols = mixed_case(np.random.default_rng(seed), capacity, size)
    return parity_step(config_graph, st, cols, 5_000)[0]


def timer_step_case(waiting=200, size=4096, seed=11):
    """numpy arrays of a timer-graph state where ``waiting`` instances wait
    on their timers (driven there on the CPU), and a batch of TIMER
    commands: CREATEs, TRIGGERs of live timers and of an unknown key, two
    CANCEL rows for one key, a TRIGGER and a CANCEL of one key, padded to
    ``size`` rows (B > 2048: the large-batch branches)."""
    import numpy as np

    from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
    from zeebe_tpu_torch.protocol.intents import TimerIntent as TI
    from zeebe_tpu_torch.tpu import batch as rb, state as state_mod

    st, _totals, _ = drive_config(1, waiting, "cpu", model_fn=timer_model)
    st = state_mod.state_to_numpy(st)
    live = np.nonzero(st["timer_key"] >= 0)[0]
    if len(live) != waiting:
        raise AssertionError(f"{len(live)} live timers, {waiting} expected")
    rng = np.random.default_rng(seed)
    slots = rng.permutation(live)
    rows = ([(TI.CREATE, s) for s in slots[:16]] + [(TI.TRIGGER, None)]
            + [(TI.CANCEL, slots[16]), (TI.CANCEL, slots[16])]
            + [(TI.TRIGGER, slots[17]), (TI.CANCEL, slots[17])]
            + [(TI.TRIGGER, s) for s in slots[18:]])
    cols = rb.batch_to_numpy(rb.empty(size, 8, device="cpu"))
    at = rng.choice(size, len(rows), replace=False)  # spread over the batch
    for i, (intent, slot) in zip(np.sort(at), rows):
        cols["valid"][i] = True
        cols["rtype"][i] = int(RecordType.COMMAND)
        cols["vtype"][i] = int(ValueType.TIMER)
        cols["intent"][i] = int(intent)
        if slot is None:
            cols["key"][i] = 5 * 10**9 + 3  # no timer has this key
            continue
        cols["key"][i] = -1 if intent == TI.CREATE else st["timer_key"][slot]
        cols["aux_key"][i] = st["timer_aik"][slot]
        cols["instance_key"][i] = st["timer_instance_key"][slot]
        cols["deadline"][i] = st["timer_due"][slot] + (TIMER_MS if intent == TI.CREATE else 0)
        cols["wf"][i] = st["timer_wf"][slot]
        cols["elem"][i] = st["timer_elem"][slot]
    return st, cols


def parity_step(graph_fn, st, cols, now):
    """One step of ``graph_fn()``'s graph on the card and on the CPU from
    the same numpy state and batch: state, emissions and stats bit-equal."""
    import numpy as np

    from zeebe_tpu_torch.tpu import batch as rb, kernel, state as state_mod

    out = {}
    for device in ("cuda", "cpu"):
        graph, _meta = graph_fn(device)
        s, e, stats = kernel.step_kernel(
            graph, state_mod.state_from_numpy(st, device=device),
            rb.batch_from_numpy(cols, device=device), now, synthetic_workers=True)
        out[device] = ({**state_mod.state_to_numpy(s), **{
            "emit." + k: v for k, v in rb.batch_to_numpy(e).items()}},
            {k: int(v) for k, v in stats.items()})
    (a, sa), (c, sc) = out["cuda"], out["cpu"]
    bad = [k for k in a if a[k].dtype != c[k].dtype or a[k].shape != c[k].shape
           or not np.array_equal(np.atleast_1d(a[k]).view(np.uint8),
                                 np.atleast_1d(c[k]).view(np.uint8))]
    if bad or sa != sc:
        raise AssertionError(f"step differs between cuda and cpu: {bad} {sa} {sc}")
    return sa, a


def parity_timer_step():
    """Phase 3's timer step: the live-timer lookup, CREATE into the timer
    table and map, TRIGGER (found, unknown), duplicate CANCELs."""
    st, cols = timer_step_case()
    stats, out = parity_step(lambda device: config_graph(device, timer_model),
                             st, cols, 1_000_000 + TIMER_MS)
    # left: the 16 timers the CREATE rows were modelled on and the 16 new
    live = int((out["timer_key"] >= 0).sum())
    if live != 32 or stats["overflow"]:
        raise AssertionError(f"timer table after the step: {live} live timers, {stats}")
    return stats


def parity_tick(wave=1024):
    """Phase 3's ``tick_kernel`` calls on the card and on the CPU from the
    same numpy state: a config-4 state whose wave waits on its timers
    (driven there on the CPU), at the tick 31 s later; and the mixed
    step's state, whose activated jobs are past their deadlines. Equal
    batches and counts, bit for bit."""
    import numpy as np

    from zeebe_tpu_torch.tpu import batch as rb, drive, kernel, state as state_mod

    graph, state, queue, meta = c4_setup(wave, "cpu")
    queue = drive.enqueue(queue, c4_creates(meta, wave, graph.num_vars, "cpu", 0))
    state, queue, _t = drive.run_to_quiescence(graph, state, queue, 0, wave)
    jobs_st, _cols = mixed_case(np.random.default_rng(7), 8192, 64)
    counts = {}
    for label, st, now in (("timers", state_mod.state_to_numpy(state), C4_TICK_MS),
                           ("jobs", jobs_st, 5_000)):
        out = {}
        for device in ("cuda", "cpu"):
            batch, count = kernel.tick_kernel(state_mod.state_from_numpy(st, device=device),
                                              now)
            out[device] = (rb.batch_to_numpy(batch), int(count))
        (a, ca), (c, cc) = out["cuda"], out["cpu"]
        bad = [k for k in a if not np.array_equal(a[k].view(np.uint8), c[k].view(np.uint8))]
        if bad or ca != cc or ca <= 0:
            raise AssertionError(f"tick ({label}) differs between cuda and cpu: {bad} "
                                 f"{ca} {cc}")
        counts[label] = ca
    if counts["timers"] != wave:
        raise AssertionError(f"tick: {counts['timers']} due timers, {wave} expected")
    return counts


# ---------------------------------------------------------------------------
# phase 6: the serving path — client → Broker log → CudaPartitionEngine →
# job pushed to a worker → completion → log
# ---------------------------------------------------------------------------

# the serving benchmark's settings: 2,048 config-1 instances (bench.py:312),
# engine capacity max(4096, 2 * instances) (bench.py:336), one worker with
# 256 credits (bench.py:394), num_vars 16 and sub_capacity 16
# (runtime/config.py:100-102); config 3 at the side-config quarter
# (bench.py:2381) of the same capacity
SERVE_CREDITS = 256
SERVE_CAPACITY = 4096
SERVE_INSTANCES = 2048
SERVE_INSTANCES_C3 = SERVE_INSTANCES // 4
# config 2, the timer workflow and configs 4 and 5 at the same quarter
SERVE_INSTANCES_C2 = SERVE_INSTANCES // 4
SERVE_INSTANCES_TIMER = SERVE_INSTANCES // 4
SERVE_INSTANCES_C4 = SERVE_INSTANCES // 4
SERVE_INSTANCES_C5 = SERVE_INSTANCES // 4
# signature records per served timer instance
SIGNATURE_PER_TIMER_INSTANCE = 29
# the wrappers a served wave of each config must launch; the boot
# self-check's own
SERVING_KERNELS = {"config1": CONFIG1_KERNELS, "config2": CONFIG1_KERNELS,
                   "config3": CONFIG3_KERNELS, "timers": TIMER_KERNELS,
                   "config4": CONFIG4_KERNELS, "config5": CONFIG5_KERNELS}
SELFCHECK_KERNELS = ("insert", "lookup", "delete", "masked_row_update",
                     "masked_lane_update", "masked_lane_accum")

# the log signature of tests/test_tpu_parity.py:36-64
SIG_TYPES = ("WORKFLOW_INSTANCE", "JOB", "INCIDENT", "TIMER", "MESSAGE",
             "MESSAGE_SUBSCRIPTION", "WORKFLOW_INSTANCE_SUBSCRIPTION")


def record_signature(records):
    from zeebe_tpu_torch.protocol.enums import ValueType

    types = {int(ValueType[name]) for name in SIG_TYPES}
    out = []
    for r in records:
        if int(r.metadata.value_type) not in types:
            continue
        out.append((
            r.position, int(r.metadata.record_type), int(r.metadata.value_type),
            int(r.metadata.intent), r.key, r.source_record_position,
            int(r.metadata.rejection_type), r.metadata.rejection_reason,
            getattr(r.value, "activity_id", None) or None,
            dict(getattr(r.value, "payload", {}) or {}),
            getattr(r.value, "scope_instance_key", None),
            getattr(r.value, "workflow_instance_key", None),
            getattr(r.value, "retries", None),
            getattr(r.value, "worker", None),
            getattr(r.value, "error_type", None),
            getattr(r.value, "error_message", None),
            getattr(getattr(r.value, "headers", None), "activity_instance_key", None),
        ))
    return out


def order_payload(i):
    """The served CREATE payload: bench.stage_creates' {orderId, orderValue 99}."""
    return {"orderId": i, "orderValue": 99}


def c4_payload(i):
    """Config 4's CREATE payload: the numeric correlation key oid."""
    return {"oid": i}


def c4_publisher(step):
    """A ``serve`` hook: a burst of PUBLISH "paid" {paid: true} commands, one
    for every ``step``-th instance from the first, written to the log at
    once as the CREATEs are (the others expire through the timer
    boundary)."""
    from zeebe_tpu_torch.protocol.intents import MessageIntent
    from zeebe_tpu_torch.protocol.records import MessageRecord

    def publish(client, instances):
        for i in range(0, instances, step):
            client.broker.write_command(0, MessageRecord(
                name="paid", correlation_key=str(i), time_to_live=0,
                payload={"paid": True},
            ), MessageIntent.PUBLISH)

    return publish


def oracle_records_per_instance(model_fn, instances=4, **scenario):
    """Signature records the port's host oracle writes per instance of a
    ``serve`` scenario (a credit for every job), in a data directory of its
    own under ``build/``."""
    import shutil
    import tempfile

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(root, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="oracle-", dir=root)
    try:
        _engine, records, _wall, _ticks = serve(model_fn, instances, "oracle", workdir,
                                                credits=16 * instances, **scenario)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return len(record_signature(records)) / instances


def oracle_counts():
    """Records a correlated and an expired config-4 instance, a config-4
    instance up to its wait on the receive task (neither published to nor
    timed out) and a config-5 instance write on the port's host oracle: the
    counts the drives of phases 3, 5c and 5d and the served runs of 6a are
    held to."""
    c4 = dict(payload=c4_payload, advance_ms=C4_TICK_MS)
    return {
        "config4_correlated": oracle_records_per_instance(
            config4_model, after_create=c4_publisher(1), **c4),
        "config4_expired": oracle_records_per_instance(config4_model, **c4),
        "config4_waiting": oracle_records_per_instance(config4_model, payload=c4_payload),
        "config5": oracle_records_per_instance(config5_model),
    }


def alternating_payload(i):
    """orderValue 99 and 10 in turns: config 2's two branches."""
    return {"orderId": i, "orderValue": (99, 10)[i % 2]}


def _port_broker(device, workdir, partitions=1, clock=None, data_dir=None, exporters=None,
                 capacity=SERVE_CAPACITY):
    """The port's in-process Broker whose partitions run CudaPartitionEngine
    on ``device`` ("cuda", "cpu"), or the port's host oracle ("oracle")."""
    import tempfile

    from zeebe_tpu_torch.engine.interpreter import WorkflowRepository
    from zeebe_tpu_torch.runtime import Broker, ControlledClock
    from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

    clock = clock or ControlledClock(start_ms=1_000_000)
    repo = WorkflowRepository()
    return Broker(
        num_partitions=partitions, clock=clock, exporters=exporters,
        data_dir=data_dir or tempfile.mkdtemp(prefix="broker-", dir=workdir),
        engine_factory=None if device == "oracle" else (
            lambda pid: CudaPartitionEngine(
                pid, partitions, repository=repo, clock=clock, capacity=capacity,
                num_vars=16, sub_capacity=16, device=device)),
    )


def tick_until_quiet(broker):
    """Tick (each tick drains) until a tick adds no record to partition 0's
    log; returns the ticks."""
    log_ = broker.partitions[0].log
    ticks = 0
    while True:
        before = log_.next_position
        broker.tick()
        broker.run_until_idle()
        ticks += 1
        if log_.next_position == before:
            return ticks


def serve(model_fn, instances, device, workdir, credits=SERVE_CREDITS,
          capacity=SERVE_CAPACITY, payload=order_payload, advance_ms=0,
          after_create=None, marks=None):
    """Serve ``instances`` instances of one config through the port's
    in-process Broker on ``device`` ("cuda", "cpu", or "oracle": the port's
    copy of the host oracle engine instead of CudaPartitionEngine): deploy
    through the client, one job worker, a burst of CREATE commands written
    to the log at once, one drain, ``after_create(client, instances)`` and
    a drain, the clock moved on by ``advance_ms``, then ticks (each drains)
    until a tick adds no record; ``marks``, a list, gets the log's next
    position after the CREATEs' drain and after ``after_create``'s. Closes
    the broker and returns its engine, its log, the wall seconds from the
    first CREATE to the last record, and the number of ticks."""
    import torch

    from zeebe_tpu_torch.gateway import JobWorker, ZeebeClient
    from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI
    from zeebe_tpu_torch.protocol.records import WorkflowInstanceRecord
    from zeebe_tpu_torch.runtime import ControlledClock

    clock = ControlledClock(start_ms=1_000_000)
    broker = _port_broker(device, workdir, clock=clock, capacity=capacity)
    engine = broker.partitions[0].engine
    model = model_fn()
    client = ZeebeClient(broker)
    client.deploy_model(model)
    JobWorker(broker, "payment-service", lambda ctx: {"paid": True},
              credits=credits)
    process_id = model.processes[0].id
    log_ = broker.partitions[0].log
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(instances):
        broker.write_command(0, WorkflowInstanceRecord(
            bpmn_process_id=process_id, payload=payload(i),
        ), WI.CREATE)
    broker.run_until_idle()
    marks = [] if marks is None else marks
    marks.append(log_.next_position)
    if after_create is not None:
        after_create(client, instances)
        broker.run_until_idle()
    marks.append(log_.next_position)
    clock.advance(advance_ms)
    ticks = tick_until_quiet(broker)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    records = broker.records(0)
    broker.close()
    return engine, records, wall, ticks


def serve_checked(label, model_fn, instances, per_instance, workdir,
                  payload=order_payload, advance_ms=0, after_create=None):
    """Phase 6a for one config on the card, the launch counters zeroed
    just before and read just after. ``per_instance`` is the signature
    records per instance, or a tuple of them for each stage of ``serve``
    (the CREATEs' drain, ``after_create``'s, the ticks') to hold each
    stage's records to."""
    import torch

    from zeebe_tpu_torch.protocol.enums import ValueType
    from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    marks = []
    engine, records, wall, ticks = serve(model_fn, instances, "cuda", workdir,
                                         payload=payload, advance_ms=advance_ms,
                                         after_create=after_create, marks=marks)
    launches = launch_counts()
    commits = commit_device_launches(label)
    sig = record_signature(records)
    if isinstance(per_instance, tuple):
        bounds = [0, *marks, float("inf")]
        got = [sum(1 for r in sig if lo <= r[0] < hi)
               for lo, hi in zip(bounds, bounds[1:])]
        want = [int(n * instances) for n in per_instance]
        if got != want:
            raise AssertionError(f"{label}: signature records by stage {got} != {want}")
        per_instance = sum(per_instance)
    completed = sum(
        1 for r in records
        if int(r.metadata.value_type) == int(ValueType.WORKFLOW_INSTANCE)
        and int(r.metadata.intent) == int(WI.ELEMENT_COMPLETED)
        and r.key == getattr(r.value, "workflow_instance_key", None)
    )
    if completed != instances:
        raise AssertionError(f"{label}: {completed} of {instances} processes completed")
    if len(sig) != int(per_instance * instances):
        raise AssertionError(
            f"{label}: {len(sig)} signature records != {per_instance} x {instances}")
    if engine.host_only_reasons:
        raise AssertionError(f"{label}: workflows served host-side: "
                             f"{engine.host_only_reasons}")
    if engine.graph.has_messages and not engine._messages_on_device:
        raise AssertionError(f"{label}: the message store is host-side")
    if engine._host.element_instances.instances:
        raise AssertionError(f"{label}: instances left in the embedded oracle")
    if engine.host_records_processed > len(records) - len(sig):
        raise AssertionError(f"{label}: instance records processed host-side")
    zero = [k for k in SERVING_KERNELS[label] if launches[k] <= 0]
    if zero:
        raise AssertionError(f"{label}: kernels never launched serving: {zero}")
    in_flight = engine.job_records_in_flight()
    if in_flight:
        raise AssertionError(f"{label}: job records in flight at rest: "
                             f"{sorted(in_flight.items())[:5]}")
    return {
        "instances": instances, "credits": SERVE_CREDITS, "capacity": SERVE_CAPACITY,
        "records": len(records), "signature_records": len(sig),
        "device_records": engine.device_records_processed,
        "host_records": engine.host_records_processed, "ticks": ticks,
        "wall_seconds": wall, "records_per_sec": len(records) / wall,
        "launches": launches, "commit_launches": commits,
        "peak_bytes": torch.cuda.max_memory_allocated(), "signature": sig,
        "in_flight_at_rest": len(in_flight),
    }


def _same_log(label, a, b, what):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            raise AssertionError(f"{label}: {what} differ at signature record {i}: "
                                 f"{x} vs {y}")
    if len(a) != len(b):
        raise AssertionError(f"{label}: {what} differ in length: {len(a)} vs {len(b)}")


def serve_parity_with_oracle(label, model_fn, cuda_sig, instances, workdir,
                             payload=order_payload, advance_ms=0, after_create=None,
                             jobs_per_instance=1):
    """Phase 6b for a served run of 6a: the same scenario on the CPU writes
    the card's log signature; and with credits for every job of every
    instance, the card and the port's host oracle write the same log. (In a
    credit drought the JAX engine, which the port follows, and the oracle
    re-assign stranded jobs in another order: ROADMAP's note on the
    reference.)"""
    credits = instances * jobs_per_instance
    out = {"instances": instances, "signature_records": len(cuda_sig), "credits": credits}
    _engine, records, out["cpu_seconds"], _ticks = serve(
        model_fn, instances, "cpu", workdir, payload=payload, advance_ms=advance_ms,
        after_create=after_create)
    _same_log(label, cuda_sig, record_signature(records), "cuda and cpu logs")
    sigs = {}
    for device in ("cuda", "oracle"):
        _engine, records, out[device + "_full_credit_seconds"], _ticks = serve(
            model_fn, instances, device, workdir, credits=credits, payload=payload,
            advance_ms=advance_ms, after_create=after_create)
        sigs[device] = record_signature(records)
    _same_log(label, sigs["cuda"], sigs["oracle"],
              f"cuda and oracle logs at {credits} credits")
    out["full_credit_signature_records"] = len(sigs["cuda"])
    return out


def serve_parity(workdir, instances=SERVE_INSTANCES_C3):
    """Phase 6b: config 1 in a credit drought (``instances`` instances, 256
    credits) served on the card and on the CPU: equal log signatures."""
    sigs = {}
    for device in ("cuda", "cpu"):
        _engine, records, wall, _ticks = serve(config1_model, instances, device, workdir)
        sigs[device] = (record_signature(records), wall)
    (a, wa), (c, wc) = sigs["cuda"], sigs["cpu"]
    for i, (x, y) in enumerate(zip(a, c)):
        if x != y:
            raise AssertionError(f"serving log differs at signature record {i}: "
                                 f"cuda {x} cpu {y}")
    if len(a) != len(c):
        raise AssertionError(f"serving logs differ in length: {len(a)} vs {len(c)}")
    return {"instances": instances, "signature_records": len(a),
            "cuda_seconds": wa, "cpu_seconds": wc}


# ---------------------------------------------------------------------------
# phase 8: the cluster serving path — ClusterClient → TCP → ClusterBroker →
# raft append and commit → the WaveScheduler drain → CudaPartitionEngine →
# worker push (bench.py:312 run_serving_path)
# ---------------------------------------------------------------------------

# bench.py's serving settings: 2,048 instances from 8 pump threads, one
# worker with 256 credits, capacity max(4096, 2 * 2048) (bench.py:312-420)
CLUSTER_INSTANCES = 2048
CLUSTER_PUMPS = 8
CLUSTER_PHASE_LIMIT_S = 300
# 8b: three brokers, replication factor 3, two partitions
FAILOVER_INSTANCES = 256
# 8c: instances served through python -m zeebe_tpu_torch
ENTRY_INSTANCES = 64
# 8d: the sloth worker's job timeout (on the broker's controlled clock)
STRANDED_TIMEOUT_MS = 400
# the wrappers a served config-1 wave launches (no rebuild is needed at
# these key counts, so the insert is the engines' install and warm())
CLUSTER_KERNELS = ("fused_gather_rows", "fused_table_commit", "lookup")


def serve_bench_model():
    from zeebe_tpu_torch.models.bpmn.builder import Bpmn

    return (Bpmn.create_process("serve-bench").start_event()
            .service_task("work", type="payment-service").end_event().done())


def _cluster_cfg(node_id, engine_type, partitions=1, fast=False):
    from zeebe_tpu_torch.runtime.config import BrokerCfg

    cfg = BrokerCfg()
    cfg.network.client_port = 0
    cfg.network.management_port = 0
    cfg.network.subscription_port = 0
    cfg.metrics.port = 0
    cfg.metrics.enabled = False
    cfg.cluster.node_id = node_id
    cfg.cluster.partitions = partitions
    cfg.engine.type = engine_type
    cfg.engine.capacity = max(4096, 2 * CLUSTER_INSTANCES)
    if fast:  # tests/test_cluster.py:39-54's timings
        cfg.raft.heartbeat_interval_ms = 30
        cfg.raft.election_timeout_ms = 200
        cfg.gossip.probe_interval_ms = 50
        cfg.gossip.probe_timeout_ms = 250
        cfg.gossip.sync_interval_ms = 500
        cfg.data.snapshot_replication_period_ms = 300
    return cfg


def _gc_pauses():
    """Record the garbage collector's pauses from now on. A pause stops
    every broker of this process at once, and a pause longer than the
    election timeout reads to their raft as a leader gone quiet. Returns
    a function that stops recording and gives (pauses over 100 ms, the
    longest in seconds)."""
    import gc

    began, pauses = [0.0], []

    def on_gc(phase, _info):
        if phase == "start":
            began[0] = time.perf_counter()
        else:
            pauses.append(time.perf_counter() - began[0])

    gc.callbacks.append(on_gc)

    def stop():
        if on_gc in gc.callbacks:
            gc.callbacks.remove(on_gc)
        return sum(p > 0.1 for p in pauses), max(pauses, default=0.0)

    return stop


def _freeze_heap():
    """Collect, then move every object left to the collector's permanent
    generation: the brokers a phase starts share this process with what
    the earlier phases left, and a full collection over it all would pause
    them together (a node of a real cluster runs in a process of its own)."""
    import gc

    gc.collect()
    gc.freeze()


def _wait(predicate, timeout, what, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


def _completions(log_):
    """instance key → process-level ELEMENT_COMPLETED events in the
    committed log, and the counts of (record type, value type, intent)."""
    import collections

    from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
    from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI

    done, kinds = collections.Counter(), collections.Counter()
    for r in log_.reader(0).read_committed():
        md = r.metadata
        kinds[(md.record_type.name, md.value_type.name, int(md.intent))] += 1
        if (md.value_type == ValueType.WORKFLOW_INSTANCE
                and md.record_type == RecordType.EVENT
                and int(md.intent) == int(WI.ELEMENT_COMPLETED)
                and r.key == r.value.workflow_instance_key):
            done[r.key] += 1
    return done, kinds


def _activations(log_):
    """Of the committed log: the job keys with more than one ACTIVATE
    command, the count of ACTIVATE commands, and the count of JOB commands
    rejected. A job activated twice shows as a second ACTIVATE and its
    rejection."""
    import collections

    from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
    from zeebe_tpu_torch.protocol.intents import JobIntent

    activates, rejected = collections.Counter(), 0
    for r in log_.reader(0).read_committed():
        md = r.metadata
        if md.value_type != ValueType.JOB:
            continue
        if md.record_type == RecordType.COMMAND and int(md.intent) == int(JobIntent.ACTIVATE):
            activates[r.key] += 1
        rejected += md.record_type == RecordType.COMMAND_REJECTION
    return [k for k, n in activates.items() if n > 1], sum(activates.values()), rejected


def _quiet_in_flight(broker, pids, label, timeout=120):
    """Wait until partitions ``pids`` of ``broker`` are quiet (every record
    of their logs committed and processed, the logs unchanged over half a
    second), then read each CudaPartitionEngine's job records in flight on
    the broker's actor: a quiet partition has none. Returns their count."""

    def quiet():
        for pid in pids:
            server = broker.partitions[pid]
            log_ = server.log
            if (log_.commit_position != log_.next_position - 1
                    or server.next_read_position <= log_.commit_position):
                return False
        return True

    def settled():
        if not quiet():
            return False
        before = [broker.partitions[pid].log.next_position for pid in pids]
        time.sleep(0.5)
        return quiet() and before == [broker.partitions[pid].log.next_position
                                      for pid in pids]

    _wait(settled, timeout, f"{label}: the partitions at rest", interval=0.1)
    left = {}
    for pid in pids:
        read = getattr(broker.partitions[pid].engine, "job_records_in_flight", None)
        if read is not None:
            counts = broker.actor_control.call(read).join(30)
            if counts:
                left[pid] = sorted(counts.items())[:5]
    if left:
        raise AssertionError(f"{label}: job records in flight in quiet partitions: {left}")
    return sum(len(v) for v in left.values())


def cluster_serve(engine_type, workdir):
    """8a: one ClusterBroker node with the BrokerCfg() defaults (waveSize
    512) and ports the OS picks, its engine from
    ``engine_factory_from_config`` ([engine] type = ``engine_type``), a
    ClusterClient over TCP, the serve-bench process, one worker with 256
    credits; one warm-up instance, then CLUSTER_INSTANCES from
    CLUSTER_PUMPS threads. Every instance must complete exactly once inside
    the phase limit."""
    import statistics as stats
    import tempfile
    import threading

    from zeebe_tpu_torch.gateway.cluster_client import ClusterClient
    from zeebe_tpu_torch.runtime.cluster_broker import ClusterBroker
    from zeebe_tpu_torch.runtime.engines import engine_factory_from_config
    from zeebe_tpu_torch.runtime.metrics import GLOBAL_REGISTRY

    instances, pumps = CLUSTER_INSTANCES, CLUSTER_PUMPS
    _freeze_heap()
    cfg = _cluster_cfg("serve-0", engine_type)
    broker = ClusterBroker(cfg, tempfile.mkdtemp(prefix="cluster-", dir=workdir),
                           engine_factory=engine_factory_from_config(cfg))
    client = None
    try:
        t_start = time.perf_counter()
        broker.open_partition(0).join(600)
        broker.bootstrap_partition(0, {})
        _wait(lambda: broker.partitions[0].is_leader, 600, "leadership")
        leader_s = time.perf_counter() - t_start
        client = ClusterClient([broker.client_address], num_partitions=1,
                               request_timeout_ms=300_000)
        client.deploy_model(serve_bench_model())
        done_cond = threading.Condition()
        done_at, pushes = {}, [0]

        def on_job(pid, rec):
            with done_cond:
                done_at.setdefault(rec.value.headers.workflow_instance_key,
                                   time.perf_counter())
                pushes[0] += 1
                done_cond.notify_all()
            return {}

        worker = client.open_job_worker("payment-service", on_job, credits=SERVE_CREDITS)
        client.create_instance("serve-bench", payload={"w": 1})  # warm-up
        with done_cond:
            if not done_cond.wait_for(lambda: pushes[0] > 0, timeout=240):
                raise AssertionError(f"8a {engine_type}: the warm-up instance never completed")
        counter = GLOBAL_REGISTRY.counter
        names = ("serving_waves_total", "serving_wave_records_total",
                 "serving_host_seconds_total", "serving_device_seconds_total")
        at_t0 = {n: counter(n).value for n in names}
        records_t0 = broker.partitions[0].log.next_position
        warm_pushes = pushes[0]
        starts, errors = {}, []

        def pump(k):
            for _ in range(instances // pumps):
                t_send = time.perf_counter()
                try:
                    rsp = client.create_instance("serve-bench", payload={"k": k})
                except Exception as e:  # noqa: BLE001 - reported below as a failure
                    errors.append(repr(e)[:200])
                    return
                starts[rsp.value.workflow_instance_key] = t_send

        t0 = time.perf_counter()
        threads = [threading.Thread(target=pump, args=(k,), daemon=True)
                   for k in range(pumps)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(CLUSTER_PHASE_LIMIT_S)
        with done_cond:
            done_cond.wait_for(lambda: pushes[0] - warm_pushes >= instances,
                               timeout=max(1.0, CLUSTER_PHASE_LIMIT_S
                                           - (time.perf_counter() - t0)))
        elapsed = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"8a {engine_type}: pumps failed: {errors[:3]}")
        if len(starts) != instances or pushes[0] - warm_pushes != instances:
            raise AssertionError(f"8a {engine_type}: {len(starts)} created, "
                                 f"{pushes[0] - warm_pushes} pushed of {instances} "
                                 f"in {elapsed:.1f} s")
        records = broker.partitions[0].log.next_position - records_t0
        now = {n: counter(n).value - at_t0[n] for n in names}
        worker.close()
        in_flight = _quiet_in_flight(broker, [0], f"8a {engine_type}")
        # every instance's end is committed, exactly once
        log_ = broker.partitions[0].log
        _wait(lambda: set(starts) <= set(_completions(log_)[0]), 60,
              "every instance's end in the log")
        done, kinds = _completions(log_)
        twice = [k for k in starts if done[k] != 1]
        if twice or len(done) != instances + 1:
            raise AssertionError(f"8a {engine_type}: {len(done)} instances completed, "
                                 f"not once: {twice[:5]}")
        engine = broker.partitions[0].engine
        latencies = sorted(done_at[k] - t for k, t in starts.items())
        out = {
            "engine": engine_type, "instances": instances, "pumps": pumps,
            "credits": SERVE_CREDITS, "leader_seconds": leader_s,
            "records": records, "elapsed_seconds": elapsed,
            "records_per_sec": records / elapsed, "instances_per_sec": instances / elapsed,
            "p50_latency_ms": 1000 * latencies[len(latencies) // 2],
            "p99_latency_ms": 1000 * latencies[min(len(latencies) - 1,
                                                   int(len(latencies) * 0.99))],
            "mean_latency_ms": 1000 * stats.fmean(latencies),
            "waves": now["serving_waves_total"],
            "wave_records": now["serving_wave_records_total"],
            "host_seconds": now["serving_host_seconds_total"],
            "device_seconds": now["serving_device_seconds_total"],
            "kinds": kinds, "engine_class": type(engine).__name__,
            "in_flight_at_rest": in_flight,
        }
        if engine_type == "cuda":
            from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

            if not isinstance(engine, CudaPartitionEngine):
                raise AssertionError(f"8a: the partition is served by {type(engine)}")
            if engine.device.type != "cuda":
                raise AssertionError(f"8a: the engine is on {engine.device}")
            if engine.device_records_processed <= 0 or engine.host_only_reasons:
                raise AssertionError(
                    f"8a: device records {engine.device_records_processed}, host-only "
                    f"{engine.host_only_reasons}")
            out["device_records"] = engine.device_records_processed
            out["host_records"] = engine.host_records_processed
        return out
    finally:
        if client is not None:
            client.close()
        broker.close()


def cluster_failover(workdir):
    """8b: three ClusterBrokers in this process, replication factor 3 and
    two partitions, both served by CudaPartitionEngine on one card.
    FAILOVER_INSTANCES per partition, then ``snapshot_all()`` on each leader:
    every replica holds a snapshot that decodes as FORMAT_DEVICE_V1. The
    leader of partition 0 is closed; its successor's engine is restored
    from the snapshot plus a replay of the committed log and serves
    as many more. Every instance completes exactly once, no job is
    activated twice in a leader's log, and the surviving replicas'
    committed logs are equal up to their common commit position. A
    replica that installed a replicated snapshot holds only the records
    after it, so each check reads what the survivors' logs hold."""
    import tempfile

    from zeebe_tpu_torch.gateway.cluster_client import ClusterClient
    from zeebe_tpu_torch.log import stateser
    from zeebe_tpu_torch.runtime.cluster_broker import ClusterBroker
    from zeebe_tpu_torch.runtime.engines import engine_factory_from_config
    from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

    instances = FAILOVER_INSTANCES
    root = tempfile.mkdtemp(prefix="failover-", dir=workdir)
    _freeze_heap()
    gc_pauses = _gc_pauses()
    restored = []
    restore = CudaPartitionEngine.restore_state

    def recording_restore(self, snap):
        restored.append(self)
        return restore(self, snap)

    CudaPartitionEngine.restore_state = recording_restore
    brokers, client = {}, None
    try:
        t0 = time.perf_counter()
        for i in range(3):
            cfg = _cluster_cfg(f"b{i}", "cuda", partitions=2, fast=True)
            brokers[f"b{i}"] = ClusterBroker(
                cfg, os.path.join(root, f"b{i}"),
                engine_factory=engine_factory_from_config(cfg))
        nodes = list(brokers.values())
        for broker in nodes[1:]:
            broker.join([nodes[0].gossip_address]).join(10)
        for pid in (0, 1):
            addrs = {n: b.open_partition(pid).join(10) for n, b in brokers.items()}
            for n, b in brokers.items():
                b.bootstrap_partition(pid, {m: a for m, a in addrs.items() if m != n})

        def leader_of(pid):
            for b in brokers.values():
                server = b.partitions.get(pid)
                if server is not None and server.is_leader and server.engine is not None:
                    return b
            return None

        _wait(lambda: leader_of(0) and leader_of(1), 120, "both partitions' leaders")
        client = ClusterClient([b.client_address for b in brokers.values()],
                               num_partitions=2, request_timeout_ms=120_000)
        client.deploy_model(serve_bench_model())
        worker = client.open_job_worker("payment-service", lambda pid, rec: {},
                                        credits=SERVE_CREDITS)

        def create(pid, n):
            return [client.create_instance("serve-bench", {"i": i}, partition_id=pid)
                    .value.workflow_instance_key for i in range(n)]

        def completed(pid):
            leader = leader_of(pid)
            return _completions(leader.partitions[pid].log)[0] if leader else {}

        def problems(pid, keys, must):
            """What the current leader's log shows against exactly once:
            keys completed twice, completions of no created instance, and
            ``must`` keys not completed yet."""
            done = completed(pid)
            twice = [k for k in done if done[k] != 1]
            stray = set(done) - set(keys)
            return twice, stray, set(must) - set(done)

        def views():
            """Each replica's partitions (raft state, term, serving, engine,
            commit, read cursor) and the worker's subscriptions, for a
            failure's message."""
            replicas = {f"{n}/p{p}": (s.raft.state.value, s.raft.term, s.is_leader,
                                      s.engine is not None, s.log.commit_position,
                                      s.next_read_position)
                        for n, b in brokers.items() for p, s in sorted(b.partitions.items())}
            return (f"replicas {replicas}; worker subscribed at "
                    f"{worker._subscribed_addr} terms {worker._subscribed_term}, "
                    f"{len(worker.handled)} jobs pushed")

        def settle(pid, keys, must, what):
            deadline = time.monotonic() + 120
            while any(problems(pid, keys, must)):
                if time.monotonic() > deadline:
                    twice, stray, missing = problems(pid, keys, must)
                    raise AssertionError(
                        f"8b: {what}: {len(twice)} completed twice {twice[:5]}, "
                        f"{len(stray)} stray {sorted(stray)[:5]}, {len(missing)} of "
                        f"{len(set(must))} not completed {sorted(missing)[:5]}; {views()}")
                time.sleep(0.05)

        created = {pid: create(pid, instances) for pid in (0, 1)}
        for pid in (0, 1):
            settle(pid, created[pid], created[pid], f"partition {pid}'s instances")
        serve_s = time.perf_counter() - t0
        for pid in (0, 1):
            leader = leader_of(pid)
            engine = leader.partitions[pid].engine
            if not isinstance(engine, CudaPartitionEngine) or engine.device.type != "cuda":
                raise AssertionError(f"8b: partition {pid} served by {engine}")
            leader.snapshot_all()
        _wait(lambda: all(b.partitions[p].snapshots.storage.list()
                          for b in brokers.values() for p in (0, 1)), 120,
              "every replica's snapshot")
        for b in brokers.values():
            for pid in (0, 1):
                server = b.partitions[pid]
                state, _meta = server.snapshots.recover(server.log.next_position - 1)
                if state is None or state.get("fmt") != stateser.FORMAT_DEVICE_V1:
                    raise AssertionError(f"8b: {b.node_id} holds no device snapshot "
                                         f"of partition {pid}")
        old = leader_of(0)
        t1 = time.perf_counter()
        old.close()
        del brokers[old.node_id]
        _wait(lambda: leader_of(0) is not None, 120, "partition 0's new leader")
        failover_s = time.perf_counter() - t1
        engine = leader_of(0).partitions[0].engine
        if not isinstance(engine, CudaPartitionEngine) or not any(
                e is engine for e in restored):
            raise AssertionError("8b: the new leader's engine is not restored "
                                 "from the snapshot")
        t2 = time.perf_counter()
        after = create(0, instances)
        settle(0, created[0] + after, after, "partition 0's instances after the failover")
        after_s = time.perf_counter() - t2
        _wait(lambda: leader_of(1) is not None, 120, "partition 1's leader")
        settle(1, created[1], (), "partition 1's instances after the failover")
        worker.close()
        in_flight = sum(_quiet_in_flight(leader_of(pid), [pid], "8b") for pid in (0, 1))
        activations = {}
        for pid in (0, 1):
            twice, activations[pid], rejected = _activations(leader_of(pid).partitions[pid].log)
            if twice or rejected:
                raise AssertionError(f"8b: partition {pid}: jobs activated twice "
                                     f"{twice[:5]}, {rejected} job commands rejected")
        common_positions = {}
        for pid in (0, 1):
            logs = [b.partitions[pid].log for b in brokers.values()]
            common = min(lg.commit_position for lg in logs)
            views = [[(r.position, r.raft_term, r.timestamp, int(r.metadata.record_type),
                       int(r.metadata.value_type), int(r.metadata.intent), r.key,
                       r.source_record_position)
                      for r in lg.reader(0).read_committed() if r.position <= common]
                     for lg in logs]
            first = max(v[0][0] for v in views if v)
            views = [[r for r in v if r[0] >= first] for v in views]
            if not views[0] or any(v != views[0] for v in views[1:]):
                raise AssertionError(f"8b: partition {pid}'s replicas disagree")
            common_positions[pid] = (first, common)
        return {"instances_per_partition": instances, "serve_seconds": serve_s,
                "failover_seconds": failover_s, "after_failover_seconds": after_s,
                "leader_terms": {pid: leader_of(pid).partitions[pid].raft.term
                                 for pid in (0, 1)},
                "gc_pauses": gc_pauses(),
                "restored_engines": len(restored), "common_positions": common_positions,
                "job_activations_checked": activations, "in_flight_at_rest": in_flight}
    finally:
        CudaPartitionEngine.restore_state = restore
        gc_pauses()
        if client is not None:
            client.close()
        for b in brokers.values():
            b.close()


def stranded_job(workdir):
    """8d: one ClusterBroker with ``[engine] type = "cuda"`` and a
    controlled clock for its engine (raft keeps its own), a worker with one
    credit that keeps every job it is pushed: the first job is pushed, the
    second is created with no credit free and waits in the backlog, the
    clock passes the first job's deadline (TIME_OUT from the tick), and the
    worker returns its credit. The tick's due probe raises
    PROBE_JOB_BACKLOG, ``device_backlog_activations`` writes one ACTIVATE
    (the lowest key: the timed-out first job), the job is pushed again, no
    job command is rejected, and the quiet partition counts no job record
    in flight."""
    import collections
    import tempfile

    from zeebe_tpu_torch.gateway.cluster_client import ClusterClient, RemoteJobWorker
    from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
    from zeebe_tpu_torch.protocol.intents import JobIntent
    from zeebe_tpu_torch.runtime import ControlledClock
    from zeebe_tpu_torch.runtime.cluster_broker import ClusterBroker
    from zeebe_tpu_torch.runtime.engines import engine_factory_from_config
    from zeebe_tpu_torch.tpu.engine import PROBE_JOB_BACKLOG, CudaPartitionEngine

    class Sloth(RemoteJobWorker):
        def _on_record(self, partition, record, epoch=-1):
            self.handled.append(record)

    _freeze_heap()
    clock = ControlledClock(start_ms=1_000_000)
    cfg = _cluster_cfg("stranded-0", "cuda")
    broker = ClusterBroker(cfg, tempfile.mkdtemp(prefix="stranded-", dir=workdir),
                           engine_factory=engine_factory_from_config(cfg), clock=clock)
    client = None
    try:
        broker.open_partition(0).join(600)
        broker.bootstrap_partition(0, {})
        _wait(lambda: broker.partitions[0].is_leader, 600, "8d: leadership")
        server = broker.partitions[0]
        engine = server.engine
        if not isinstance(engine, CudaPartitionEngine) or engine.device.type != "cuda":
            raise AssertionError(f"8d: the partition is served by {engine}")
        scans, probes = [], []
        scan, probe = engine.device_backlog_activations, engine.deadlines_due_probe

        def recording_scan():
            out = scan()
            scans.append(out)
            return out

        def recording_probe():
            handle = probe()
            probes.append(handle)
            return handle

        engine.device_backlog_activations = recording_scan
        engine.deadlines_due_probe = recording_probe
        client = ClusterClient([broker.client_address], num_partitions=1,
                               request_timeout_ms=120_000)
        client.deploy_model(serve_bench_model())
        worker = Sloth(client, "payment-service", handler=None, worker_name="sloth",
                       credits=1, timeout_ms=STRANDED_TIMEOUT_MS, partitions=[0])

        def job_records(intent, record_type=RecordType.EVENT):
            return [r for r in server.log.reader(0).read_committed()
                    if r.metadata.value_type == ValueType.JOB
                    and r.metadata.record_type == record_type
                    and int(r.metadata.intent) == int(intent)]

        def processed(records):
            return bool(records) and engine.last_processed_position >= records[-1].position

        client.create_instance("serve-bench", payload={"i": 1})
        _wait(lambda: len(worker.handled) == 1, 120, "8d: the first job's push")
        client.create_instance("serve-bench", payload={"i": 2})
        _wait(lambda: len(job_records(JobIntent.CREATED)) == 2
              and processed(job_records(JobIntent.CREATED)), 120,
              "8d: the second job in the backlog")
        clock.advance(STRANDED_TIMEOUT_MS + 100)
        _wait(lambda: processed(job_records(JobIntent.TIMED_OUT)), 120,
              "8d: the first job timed out")
        if any(scans):
            raise AssertionError("8d: a backlog activation before the credit came back")
        t0 = time.perf_counter()
        worker._return_credit(0)
        _wait(lambda: len(worker.handled) == 2, 120, "8d: the stranded job's push")
        push_s = time.perf_counter() - t0
        worker.close()
        in_flight = _quiet_in_flight(broker, [0], "8d")
        backlog = [r for out in scans for r in out]
        first = worker.handled[0].key
        activates = collections.Counter(
            r.key for r in job_records(JobIntent.ACTIVATE, RecordType.COMMAND))
        rejected = len([r for r in server.log.reader(0).read_committed()
                        if r.metadata.value_type == ValueType.JOB
                        and r.metadata.record_type == RecordType.COMMAND_REJECTION])
        if ([int(r.metadata.intent) for r in backlog] != [int(JobIntent.ACTIVATE)]
                or backlog[0].key != first or worker.handled[1].key != first
                or dict(activates) != {first: 2} or rejected):
            raise AssertionError(
                f"8d: backlog activations {[(int(r.metadata.intent), r.key) for r in backlog]}, "
                f"pushes {[r.key for r in worker.handled]}, ACTIVATE commands "
                f"{dict(activates)}, {rejected} job commands rejected")
        if server.engine is not engine:
            raise AssertionError("8d: the partition's engine was reinstalled")
        backlog_bits = sum(1 for h in probes if h.is_ready() and int(h) & PROBE_JOB_BACKLOG)
        return {"timeout_ms": STRANDED_TIMEOUT_MS, "push_seconds": push_s,
                "scans": len(scans), "backlog_activations": len(backlog),
                "probes": len(probes), "probes_with_backlog_bit": backlog_bits,
                "activations": {str(k): n for k, n in activates.items()},
                "in_flight_at_rest": in_flight}
    finally:
        if client is not None:
            client.close()
        broker.close()


def entry_point(workdir):
    """8c: ``python -m zeebe_tpu_torch`` with the Dockerfile's argument
    vector and ``ZEEBE_ENGINE_TYPE``, spawned as tests/test_launcher.py
    spawns the JAX package's node: it starts with ``engine=cuda``, serves
    ENTRY_INSTANCES through ClusterClient (the gRPC gateway is
    optional: grpcio may be absent), shows device waves on its /metrics
    endpoint, and exits 0 on SIGTERM."""
    import re
    import signal
    import socket
    import tempfile
    import threading
    import urllib.request

    from zeebe_tpu_torch.gateway.cluster_client import ClusterClient
    from zeebe_tpu_torch.transport import RemoteAddress

    instances = ENTRY_INSTANCES
    here = os.path.dirname(os.path.abspath(__file__))
    offset = None
    for off in range(100, 900, 7):
        try:
            for base in (26500, 26501, 26502, 26503, 26504, 9600):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", base + 10 * off))
            offset = off
            break
        except OSError:
            continue
    if offset is None:
        raise AssertionError("8c: no free port block")
    env = dict(os.environ, ZEEBE_NODE_ID="node-0", ZEEBE_HOST="127.0.0.1",
               ZEEBE_PORT_OFFSET=str(offset), ZEEBE_ENGINE_TYPE="cuda")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "zeebe_tpu_torch", "--config",
         os.path.join(here, "dist", "zeebe.cfg.toml"), "--data-dir",
         tempfile.mkdtemp(prefix="node-", dir=workdir)],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []

    def drain():
        for line in proc.stdout:
            lines.append(line)

    threading.Thread(target=drain, daemon=True).start()
    client = None
    try:
        _wait(lambda: any("zeebe-tpu broker" in ln for ln in lines) or proc.poll() is not None,
              120, "the node's start-up line")
        start = next((ln for ln in lines if "zeebe-tpu broker" in ln), "")
        if "engine=cuda" not in start:
            raise AssertionError("8c: the node did not start with engine=cuda:\n"
                                 + "".join(lines))
        host, port = re.search(r"client=(\S+):(\d+)", start).groups()
        client = ClusterClient([RemoteAddress(host, int(port))], num_partitions=1,
                               request_timeout_ms=120_000)
        deadline = time.monotonic() + 120
        while True:  # the node bootstraps its partition after the line
            try:
                client.deploy_model(serve_bench_model())
                break
            except Exception:  # noqa: BLE001 - retried until the deadline
                if time.monotonic() > deadline or proc.poll() is not None:
                    raise
                time.sleep(0.2)
        ready_s = time.perf_counter() - t0
        pushed = []
        worker = client.open_job_worker("payment-service",
                                        lambda pid, rec: pushed.append(rec.key) or {})
        t1 = time.perf_counter()
        for i in range(instances):
            client.create_instance("serve-bench", {"i": i})
        _wait(lambda: len(pushed) >= instances, 120, "8c's jobs")
        serve_s = time.perf_counter() - t1
        worker.close()
        client.close()
        client = None
        with urllib.request.urlopen(
                f"http://127.0.0.1:{9600 + 10 * offset}/metrics", timeout=10) as rsp:
            metrics = rsp.read().decode()
        device_s = sum(float(m) for m in re.findall(
            r"^zb_serving_device_seconds_total(?:\{[^}]*\})? (\S+)", metrics, re.M))
        waves = sum(float(m) for m in re.findall(
            r"^zb_serving_waves_total(?:\{[^}]*\})? (\S+)", metrics, re.M))
        if waves <= 0 or device_s <= 0:
            raise AssertionError(f"8c: the node's /metrics shows {waves} waves and "
                                 f"{device_s} device seconds")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        if rc != 0:
            raise AssertionError(f"8c: the node exited {rc}:\n" + "".join(lines[-20:]))
        gateway = next((ln.strip() for ln in lines
                        if "gateway" in ln and ("disabled" in ln or "gRPC" in ln)), "")
        return {"instances": instances, "ready_seconds": ready_s,
                "serve_seconds": serve_s, "waves": waves, "device_seconds": device_s,
                "gateway": gateway, "exit_code": rc, "start_line": start.strip()}
    finally:
        if client is not None:
            client.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


# ---------------------------------------------------------------------------
# phase 9: the mesh
# ---------------------------------------------------------------------------

# 9a: one partition's state sharded, config 1 at its accelerator capacity
MESH_CAPACITY = 1 << 16
MESH_WAVE = 512  # the BrokerCfg() wave
MESH_RESIDENT = 4096
MESH_INSTANCES = 2048
# (span, routing, routed lane slots): the single-device baseline first; the
# last run's lanes are narrower than a wave, so its CREATE waves overflow
MESH_RUNS = ((1, "gathered", 512), (2, "gathered", 512), (2, "resident", 512),
             (4, "gathered", 512), (4, "resident", 512), (4, "resident", 256))
MESH_KERNELS = CONFIG1_KERNELS
# 9b: bench.py:787 run_mesh_serving's defaults
MESH_PARTITIONS = 8
MESH_PLAN_DEVICES = 4
MESH_CLIENTS = 8
MESH_PER_CLIENT = 8
MESH_SHARDED = 2
MESH_CORRELATED = 64
MESH_AFTER_EXCLUSION = 64
MESH_PHASE_LIMIT_S = 300


def mesh_devices(n):
    """``n`` places on the cards there are: distinct cards while there are
    enough, else the cards named again in turn (one card, n times)."""
    import torch

    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def mesh_resident_model():
    """bench.py:900's resident process: a service task no worker serves."""
    from zeebe_tpu_torch.models.bpmn.builder import Bpmn

    return (Bpmn.create_process("mesh-resident").start_event()
            .service_task("hold", type="mesh-resident-service").end_event().done())


def mesh_flow_model():
    """bench.py:893's mesh flow: start → service task → end."""
    from zeebe_tpu_torch.models.bpmn.builder import Bpmn

    return (Bpmn.create_process("mesh-flow").start_event()
            .service_task("work", type="mesh-service").end_event().done())


def _sync_all():
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


class _StepCounts:
    """Counts the step kernel's and the lookup-state rebuild's calls (every
    route to them: the engine's, the sharded steps')."""

    def __enter__(self):
        from zeebe_tpu_torch.tpu import kernel, shard, state as state_mod

        self.steps = self.rebuilds = 0
        self._real = (kernel.step_kernel, state_mod.rebuild_lookup_state)
        real_step, real_rebuild = self._real

        def step(*a, **k):
            self.steps += 1
            return real_step(*a, **k)

        def rebuild(*a, **k):
            self.rebuilds += 1
            return real_rebuild(*a, **k)

        kernel.step_kernel = shard.step_kernel = step
        state_mod.rebuild_lookup_state = rebuild
        return self

    def zero(self):
        self.steps = self.rebuilds = 0

    def __exit__(self, *exc):
        from zeebe_tpu_torch.tpu import kernel, shard, state as state_mod

        kernel.step_kernel = shard.step_kernel = self._real[0]
        state_mod.rebuild_lookup_state = self._real[1]
        return False


def mesh_state_run(span, routing, lane_slots, workdir, capacity=MESH_CAPACITY,
                   resident=MESH_RESIDENT, instances=MESH_INSTANCES, device="cuda",
                   around=None):
    """9a, one run: ``CudaPartitionEngine`` with config 1's graph at
    ``capacity``, its tables over ``span`` places (``mesh_devices``), served
    through the port's in-process Broker in waves of 512: a resident set
    left waiting at a service task no worker serves, then, counted from 0,
    ``instances`` timed instances with one worker of 256 credits, ticks
    until quiet; ``around``, a context manager factory, is entered around
    that timed part. ``device="cpu"`` rehearses it on the CPU."""
    import contextlib
    import tempfile

    import torch

    from zeebe_tpu_torch.engine.interpreter import WorkflowRepository
    from zeebe_tpu_torch.gateway import JobWorker, ZeebeClient
    from zeebe_tpu_torch.protocol.enums import ValueType
    from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI
    from zeebe_tpu_torch.protocol.records import WorkflowInstanceRecord
    from zeebe_tpu_torch.runtime import Broker, ControlledClock
    from zeebe_tpu_torch.runtime.metrics import GLOBAL_REGISTRY
    from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

    cuda = device == "cuda"
    places = mesh_devices(span) if cuda else [torch.device("cpu")] * span
    kw = ({"state_shards": span, "shard_devices": places, "routing": routing,
           "routed_lane_slots": lane_slots} if span > 1 else {"device": places[0]})
    clock = ControlledClock(start_ms=1_000_000)
    repo = WorkflowRepository()
    broker = Broker(
        num_partitions=1, clock=clock, data_dir=tempfile.mkdtemp(prefix="mesh-", dir=workdir),
        engine_factory=lambda pid: CudaPartitionEngine(
            pid, 1, repository=repo, clock=clock, capacity=capacity, num_vars=16,
            sub_capacity=16, **kw),
    )
    broker.wave_size = MESH_WAVE
    engine = broker.partitions[0].engine
    exchanged = GLOBAL_REGISTRY.counter("mesh_shard_exchange_bytes_total")
    try:
        with _StepCounts() as counts:
            client = ZeebeClient(broker)
            client.deploy_model(config1_model())
            client.deploy_model(mesh_resident_model())
            JobWorker(broker, "payment-service", lambda ctx: {"paid": True},
                      credits=SERVE_CREDITS)
            for i in range(resident):
                broker.write_command(0, WorkflowInstanceRecord(
                    bpmn_process_id="mesh-resident", payload={"r": i}), WI.CREATE)
            broker.run_until_idle()
            log_ = broker.partitions[0].log
            mark = log_.next_position
            if cuda:
                _sync_all()
            reset_launches()
            counts.zero()
            waves0 = (engine.sharded_waves, engine.routed_waves, engine.fallback_waves)
            bytes0 = exchanged.value
            window = (around or contextlib.nullcontext)()
            window.__enter__()
            t0 = time.perf_counter()
            for i in range(instances):
                broker.write_command(0, WorkflowInstanceRecord(
                    bpmn_process_id="order-process", payload=order_payload(i)), WI.CREATE)
            broker.run_until_idle()
            ticks = tick_until_quiet(broker)
            if cuda:
                _sync_all()
            wall = time.perf_counter() - t0
            window.__exit__(None, None, None)
            launches = launch_counts()
            steps, rebuilds = counts.steps, counts.rebuilds
        records = broker.records(0)
    finally:
        broker.close()
    sig = record_signature(records)
    timed = sum(1 for r in records if r.position >= mark)
    completed = sum(
        1 for r in records
        if r.position >= mark and int(r.metadata.value_type) == int(ValueType.WORKFLOW_INSTANCE)
        and int(r.metadata.intent) == int(WI.ELEMENT_COMPLETED)
        and r.key == getattr(r.value, "workflow_instance_key", None))
    label = f"9a span {span} {routing}" + (f", lanes {lane_slots}" if span > 1 else "")
    if completed != instances:
        raise AssertionError(f"{label}: {completed} of {instances} instances completed")
    waves = tuple(b - a for a, b in zip(waves0, (engine.sharded_waves, engine.routed_waves,
                                                 engine.fallback_waves)))
    out = {
        "span": span, "routing": routing, "lane_slots": lane_slots,
        "places": [str(d) for d in places], "capacity": capacity, "resident": resident,
        "instances": instances, "records": timed, "wall_seconds": wall,
        "records_per_sec": timed / wall, "ticks": ticks, "steps": steps,
        "rebuilds": rebuilds, "sharded_waves": waves[0], "routed_waves": waves[1],
        "fallback_waves": waves[2], "routed_overflows": engine.routed_overflows,
        "exchange_bytes": exchanged.value - bytes0,
        "state_exchange_bytes": engine._shard_exchange_bytes,
        "launches": launches, "signature": sig,
    }
    if span > 1:
        if steps != waves[0]:
            raise AssertionError(f"{label}: {steps} steps but {waves[0]} sharded waves")
        if routing == "gathered" and out["exchange_bytes"] != engine._shard_exchange_bytes * steps:
            raise AssertionError(
                f"{label}: {out['exchange_bytes']} exchange bytes != "
                f"{engine._shard_exchange_bytes} x {steps} waves")
        if routing == "resident":
            if rebuilds != waves[1] + waves[2]:
                raise AssertionError(f"{label}: {rebuilds} rebuilds for {waves[1]} routed "
                                     f"and {waves[2]} fallback waves")
            if lane_slots >= MESH_WAVE and waves[1] <= 0:
                raise AssertionError(f"{label}: no wave took the routed step")
            if lane_slots < MESH_WAVE and (engine.routed_overflows <= 0 or waves[2] <= 0):
                raise AssertionError(f"{label}: the narrow lanes never overflowed")
    if cuda:
        want = {k: 0 for k in launches}
        for k, n in PER_ROUND["config1"].items():
            want[k] = n * steps
        want["insert"] += INSERTS_PER_REBUILD * rebuilds
        if launches != want:
            raise AssertionError(f"{label}: launches {launches} != {want} ({steps} steps, "
                                 f"{rebuilds} rebuilds)")
        # the insert launches only in rebuilds, which a short run may not need
        zero = [k for k in MESH_KERNELS if launches[k] <= 0 and (k != "insert" or rebuilds)]
        if zero:
            raise AssertionError(f"{label}: kernels never launched: {zero}")
    return out


def mesh_rebuild_ms(span, capacity=MESH_CAPACITY, reps=20):
    """The lookup-state rebuild of one shard's block (capacity / span rows;
    span 1: the whole table), CUDA events over ``reps`` rebuilds."""
    import torch

    from zeebe_tpu_torch.tpu import state as state_mod

    st = state_mod.make_state(capacity=capacity // span, num_vars=16, sub_capacity=16,
                              device="cuda")
    state_mod.rebuild_lookup_state(st)
    return time_ms(lambda: state_mod.rebuild_lookup_state(st), reps=reps)


def mesh_state_phase(workdir):
    """9a: every run of MESH_RUNS, each log's signature equal to the
    single-device run's."""
    runs = []
    for span, routing, lanes in MESH_RUNS:
        run = mesh_state_run(span, routing, lanes, workdir)
        if runs and run["signature"] != runs[0]["signature"]:
            base = runs[0]["signature"]
            i = next((i for i, (a, b) in enumerate(zip(run["signature"], base)) if a != b),
                     min(len(base), len(run["signature"])))
            raise AssertionError(f"9a span {span} {routing}: the log differs from the "
                                 f"single-device log at signature record {i}")
        runs.append(run)
    for run in runs:
        run["signature_records"] = len(run.pop("signature"))
    return {"runs": runs,
            "rebuild_ms": {str(s): mesh_rebuild_ms(s) for s in (1, 2, 4)}}


def _kinds(logs):
    """Counts of (record type, value type, intent) over committed logs."""
    import collections

    kinds = collections.Counter()
    for log_ in logs:
        for r in log_.reader(0).read_committed():
            md = r.metadata
            kinds[(int(md.record_type), int(md.value_type), int(md.intent))] += 1
    return kinds


def _roots_completed(logs, process_ids=None):
    """(partition, instance key) → process-level ELEMENT_COMPLETED events."""
    import collections

    from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
    from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI

    done = collections.Counter()
    for pid, log_ in enumerate(logs):
        for r in log_.reader(0).read_committed():
            md = r.metadata
            if (md.value_type == ValueType.WORKFLOW_INSTANCE
                    and md.record_type == RecordType.EVENT
                    and int(md.intent) == int(WI.ELEMENT_COMPLETED)
                    and r.key == r.value.workflow_instance_key
                    and (process_ids is None or r.value.bpmn_process_id in process_ids)):
                done[(pid, r.key)] += 1
    return done


def _subscriptions(logs, intent):
    """MESSAGE_SUBSCRIPTION events of ``intent`` over committed logs (an
    OPENED one: a publish then finds the subscription on its message
    partition)."""
    from zeebe_tpu_torch.protocol.enums import RecordType, ValueType

    n = 0
    for log_ in logs:
        for r in log_.reader(0).read_committed():
            md = r.metadata
            n += (md.record_type == RecordType.EVENT
                  and md.value_type == ValueType.MESSAGE_SUBSCRIPTION
                  and int(md.intent) == int(intent))
    return n


def _settled(logs, still=1.0):
    """A predicate for ``_wait``: true once no log has grown for ``still``
    seconds."""
    seen = [None, 0.0]

    def settled():
        sizes = tuple(log_.next_position for log_ in logs)
        if sizes != seen[0]:
            seen[:] = [sizes, time.monotonic()]
            return False
        return time.monotonic() - seen[1] >= still

    return settled


def _in_threads(fn, items, threads):
    """``fn(item)`` for every item, from ``threads`` threads at once (the
    requests of a client's pumps); raises the first failure."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=threads) as pool:
        for _ in pool.map(fn, items):
            pass


def mesh_serving(engine_type, workdir, partitions=MESH_PARTITIONS, clients=MESH_CLIENTS,
                 per_client=MESH_PER_CLIENT, correlated=MESH_CORRELATED,
                 after=MESH_AFTER_EXCLUSION, sharded=MESH_SHARDED, capacity=4096,
                 plan_devices=None):
    """9b: bench.py:787 ``run_mesh_serving`` on the port: one ClusterBroker
    with ``partitions`` partitions and ``[mesh] shardedPartitions =
    sharded`` (each partition's tables over a span of the plan's places),
    ``[mesh] exchange`` on, ``[engine] type = engine_type``; the plan over
    ``plan_devices`` (default: MESH_PLAN_DEVICES places on the cards
    there are). The mesh flow from ``clients`` threads of ``per_client``
    instances each on partitions picked at random (seeded), config 4's
    process on every partition with correlation keys hashed over them,
    its messages published once every subscription is open, then, once
    every instance has ended (their subscriptions' CLOSEs still on the
    way), a device excluded and ``after`` more mesh-flow instances. Every
    instance completes once, and every subscription closes.""" 
    import random
    import tempfile
    import threading

    from zeebe_tpu_torch.gateway.cluster_client import ClusterClient
    from zeebe_tpu_torch.protocol.intents import MessageSubscriptionIntent
    from zeebe_tpu_torch.runtime import ControlledClock
    from zeebe_tpu_torch.runtime.cluster_broker import ClusterBroker
    from zeebe_tpu_torch.runtime.engines import engine_factory_from_config
    from zeebe_tpu_torch.runtime.metrics import event_count
    from zeebe_tpu_torch.scheduler.placement import DevicePlan

    _freeze_heap()
    cfg = _cluster_cfg("mesh-0", engine_type, partitions=partitions)
    cfg.engine.capacity = capacity
    cfg.mesh.sharded_partitions = sharded
    cfg.mesh.exchange = True
    device = None if engine_type != "cuda" or plan_devices is None else "cpu"
    # the records' clock stands still: config 4's 30 s boundary timer would
    # otherwise race the requests' latency, and the counts are held to the
    # oracle's (raft keeps its own clock)
    broker = ClusterBroker(cfg, tempfile.mkdtemp(prefix="mesh-", dir=workdir),
                           engine_factory=engine_factory_from_config(cfg, device=device),
                           clock=ControlledClock(start_ms=1_000_000))
    plan = None
    if engine_type == "cuda":
        plan = broker.device_plan = DevicePlan(
            devices=plan_devices or mesh_devices(MESH_PLAN_DEVICES))
    client = None
    frames0 = event_count("mesh_exchange_frames")
    fallbacks0 = event_count("mesh_exchange_fallbacks")
    try:
        t_start = time.perf_counter()
        for pid in range(partitions):
            broker.open_partition(pid).join(600)
            broker.bootstrap_partition(pid, {})
        _wait(lambda: all(broker.partitions[p].is_leader for p in range(partitions)),
              600, "leadership of every partition")
        ready_s = time.perf_counter() - t_start
        logs = [broker.partitions[p].log for p in range(partitions)]
        client = ClusterClient([broker.client_address], num_partitions=partitions,
                               request_timeout_ms=300_000)
        client.deploy_model(mesh_flow_model())
        client.deploy_model(config4_model())
        worker = client.open_job_worker("mesh-service", lambda pid, rec: {},
                                        credits=SERVE_CREDITS)
        spans = None
        if plan is not None:
            spans = {p: list(broker.partitions[p].engine.device_indices)
                     for p in range(partitions)}
            if any(spans[p] != plan.device_indices(p) or len(spans[p]) != sharded
                   for p in spans):
                raise AssertionError(f"9b: spans {spans} != the plan's")
        created, errors = [], []
        lock = threading.Lock()

        def tenant(k):
            rng = random.Random(11 * 1000 + k)
            for _ in range(per_client):
                pid = rng.randrange(partitions)
                try:
                    rsp = client.create_instance("mesh-flow", payload={"t": k},
                                                 partition_id=pid)
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(repr(e)[:200])
                    return
                with lock:
                    created.append((pid, rsp.value.workflow_instance_key))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=tenant, args=(k,), daemon=True)
                   for k in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(MESH_PHASE_LIMIT_S)
        if errors or len(created) != clients * per_client:
            raise AssertionError(f"9b: {len(created)} created; {errors[:3]}")
        def correlated_create(i):
            # the key "m-i" hashes to partition i % partitions: the instance
            # on the next one sends its OPEN, and gets its CORRELATE, across
            # partitions (and across places of the plan)
            pid = (i + 1) % partitions
            rsp = client.create_instance("c4", payload={"oid": f"m-{i}"}, partition_id=pid)
            with lock:
                created.append((pid, rsp.value.workflow_instance_key))

        _in_threads(correlated_create, range(correlated), clients)
        # the logs' scans hold the interpreter the brokers' threads share:
        # poll them a few times a second
        _wait(lambda: _subscriptions(logs, MessageSubscriptionIntent.OPENED) >= correlated,
              MESH_PHASE_LIMIT_S, "every message subscription open", interval=0.25)
        _in_threads(lambda i: client.publish_message("paid", f"m-{i}", payload={"paid": True}),
                    range(correlated), clients)
        _wait(lambda: set(created) <= set(_roots_completed(logs)), MESH_PHASE_LIMIT_S,
              "every instance's end", interval=0.25)
        served_s = time.perf_counter() - t0
        moves = {}
        if plan is not None:
            moves = broker.exclude_device(1).join(120)
            _wait(lambda: all(broker.partitions[p].is_leader
                              and broker.partitions[p].engine is not None
                              for p in range(partitions)), 120, "the moved partitions")
            for p in range(partitions):
                span = list(broker.partitions[p].engine.device_indices)
                if span != plan.device_indices(p) or 1 in span:
                    raise AssertionError(f"9b: partition {p} on {span} after the "
                                         f"exclusion, the plan says {plan.device_indices(p)}")
        else:
            broker.exclude_device(1).join(120)
        t1 = time.perf_counter()
        rng = random.Random(7)
        targets = [rng.randrange(partitions) for _ in range(after)]

        def after_create(i):
            rsp = client.create_instance("mesh-flow", payload={"x": i},
                                         partition_id=targets[i])
            with lock:
                created.append((targets[i], rsp.value.workflow_instance_key))

        _in_threads(after_create, range(after), clients)
        _wait(lambda: set(created) <= set(_roots_completed(logs)), MESH_PHASE_LIMIT_S,
              "every instance's end after the exclusion", interval=0.25)
        after_s = time.perf_counter() - t1
        # every subscription closed (a completed instance's CLOSE lands after
        # its end, some of them after the exclusion) and the logs at rest
        # before they are counted
        _wait(lambda: _subscriptions(logs, MessageSubscriptionIntent.CLOSED) >= correlated,
              MESH_PHASE_LIMIT_S, "every message subscription closed", interval=0.25)
        _wait(_settled(logs), MESH_PHASE_LIMIT_S, "the logs at rest", interval=0.25)
        worker.close()
        in_flight = _quiet_in_flight(broker, range(partitions), f"9b {engine_type}")
        done = _roots_completed(logs)
        twice = [k for k in created if done[k] != 1]
        if twice or len(done) != len(created):
            raise AssertionError(f"9b: {len(done)} instances completed for {len(created)} "
                                 f"created, not once: {twice[:5]}")
        return {
            "engine": engine_type, "partitions": partitions, "sharded": sharded,
            "plan": [str(d) for d in plan.devices] if plan is not None else None,
            "spans": spans, "moves": {str(k): v for k, v in moves.items()},
            "instances": len(created), "ready_seconds": ready_s,
            "served_seconds": served_s, "after_exclusion_seconds": after_s,
            "exchange_frames": event_count("mesh_exchange_frames") - frames0,
            "correlated_across": sum(1 for i in range(correlated)
                                     if broker.partitions[0].engine.partition_for_correlation_key(
                                         f"m-{i}") != (i + 1) % partitions),
            "exchange_fallbacks": event_count("mesh_exchange_fallbacks") - fallbacks0,
            "kinds": _kinds(logs), "in_flight_at_rest": in_flight,
        }
    finally:
        if client is not None:
            client.close()
        broker.close()


def profile_mesh(workdir):
    """9a under torch.profiler: the timed part (512 instances over the
    resident set) of the single-device, the 4-way gathered and the 4-way
    resident run; device busy time against the wall time of the places'
    cards, and the kernels that take it."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    out = []
    for span, routing in ((1, "gathered"), (4, "gathered"), (4, "resident")):
        box = []

        @contextlib.contextmanager
        def around():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                yield
            box.append(prof)

        run = mesh_state_run(span, routing, MESH_WAVE, workdir, instances=512, around=around)
        events, dev_us = _device_events(box[0])
        busy_ms = sum(dev_us(e) for e in events) / 1e3
        cards = len(set(run["places"]))
        wall_ms = run["wall_seconds"] * 1e3
        top = sorted(events, key=dev_us, reverse=True)[:8]
        out.append({
            "span": span, "routing": routing, "cards": cards, "records": run["records"],
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (wall_ms * cards),
            "steps": run["steps"], "rebuilds": run["rebuilds"],
            "device_launches": sum(e.count for e in events),
            "top": [{"name": e.key[:90], "device_ms": dev_us(e) / 1e3, "count": e.count}
                    for e in top],
        })
    return out


def mesh_phase(here, report, by_path, profile=False):
    """Phase 9: 9a (one partition's state over spans of 1, 2 and 4 places)
    and 9b (bench.py:787's mesh serving on the card, then on the host
    oracle), each run's launches counted from 0."""
    import shutil
    import tempfile

    import torch

    count = torch.cuda.device_count()
    places = mesh_devices(MESH_PLAN_DEVICES)
    distinct = len(set(places))
    log(f"[9] {count} card(s): spans of 2 and 4 places lie on "
        + ("distinct cards" if distinct == MESH_PLAN_DEVICES else
           f"{distinct} card(s), each named {MESH_PLAN_DEVICES // distinct} times")
        + f" ({', '.join(map(str, places))})")
    report["mesh_cards"] = {"count": count, "places": [str(d) for d in places]}
    workdir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="mesh-", dir=workdir)
    try:
        t0 = time.perf_counter()
        state = mesh_state_phase(workdir)
        report["mesh_state"] = state
        base = state["runs"][0]
        for run in state["runs"]:
            key = f"mesh_state_{run['span']}_{run['routing']}_{run['lane_slots']}"
            by_path[key] = run["launches"]
            log(f"[9a] span {run['span']} {run['routing']}"
                + (f" (lanes {run['lane_slots']})" if run["span"] > 1 else "")
                + f" on {','.join(run['places'])}: {run['instances']} instances over "
                f"{run['resident']} resident at capacity {run['capacity']}: "
                f"{run['records']} records in {run['wall_seconds']:.3f} s = "
                f"{run['records_per_sec']:.1f} records/s (single device "
                f"{base['records_per_sec']:.1f}); {run['steps']} steps, {run['rebuilds']} "
                f"rebuilds, routed {run['routed_waves']}, fallback {run['fallback_waves']}, "
                f"overflows {run['routed_overflows']}; exchange {run['exchange_bytes']:.0f} B "
                f"({run['state_exchange_bytes']} B a gathered wave); log signature "
                f"({run['signature_records']} records) equal to the single device's; "
                f"launches {run['launches']}")
        log(f"[9a] the lookup-state rebuild of one block (capacity {MESH_CAPACITY} / span): "
            + ", ".join(f"span {s} {ms:.4f} ms" for s, ms in state["rebuild_ms"].items())
            + f" ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        reset_launches()
        serving = mesh_serving("cuda", workdir)
        by_path["mesh_serving"] = launch_counts()
        zero = [k for k in CONFIG4_KERNELS if by_path["mesh_serving"][k] <= 0]
        if zero:
            raise AssertionError(f"9b: kernels never launched: {zero}")
        oracle = mesh_serving("host", workdir)
        if serving["kinds"] != oracle["kinds"]:
            diff = {k: (serving["kinds"].get(k), oracle["kinds"].get(k))
                    for k in set(serving["kinds"]) | set(oracle["kinds"])
                    if serving["kinds"].get(k) != oracle["kinds"].get(k)}
            raise AssertionError(f"9b: the card's and the oracle's logs hold other "
                                 f"records (card, oracle): {diff}")
        if serving["exchange_frames"] <= 0 or serving["exchange_fallbacks"]:
            raise AssertionError(f"9b: {serving['exchange_frames']} frames exchanged, "
                                 f"{serving['exchange_fallbacks']} fell back")
        for r in (serving, oracle):
            r["kinds"] = {"/".join(map(str, k)): n for k, n in sorted(r["kinds"].items())}
        report["mesh_serving"], report["mesh_serving_oracle"] = serving, oracle
        log(f"[9b] {serving['partitions']} partitions, shardedPartitions "
            f"{serving['sharded']}, a plan over {serving['plan']}, [mesh] exchange on: "
            f"{serving['instances']} instances (the mesh flow from {MESH_CLIENTS} clients, "
            f"{MESH_CORRELATED} config-4 correlations across partitions, "
            f"{MESH_AFTER_EXCLUSION} after excluding device 1) each completed once; "
            f"ready in {serving['ready_seconds']:.3f} s, served in "
            f"{serving['served_seconds']:.3f} s, after the exclusion in "
            f"{serving['after_exclusion_seconds']:.3f} s; {serving['exchange_frames']:.0f} "
            f"frames over MeshExchange, {serving['exchange_fallbacks']:.0f} fell back; "
            f"spans {serving['spans']} → moved {serving['moves']}; the host oracle "
            f"({oracle['served_seconds']:.3f} s) wrote the same counts of every (record "
            f"type, value type, intent); job records in flight at rest "
            f"{serving['in_flight_at_rest']}; launches {by_path['mesh_serving']} "
            f"({time.perf_counter() - t0:.1f} s)")
        if profile:
            report["profile_mesh"] = profile_mesh(workdir)
            for row in report["profile_mesh"]:
                log(f"[p] 9a span {row['span']} {row['routing']}, 512 instances: "
                    f"{row['records']} records, wall {row['wall_ms']:.1f} ms, device busy "
                    f"{row['device_busy_ms']:.1f} ms on {row['cards']} card(s) (idle share "
                    f"{row['device_idle_share']:.3f}), {row['steps']} steps, "
                    f"{row['rebuilds']} rebuilds, {row['device_launches']} device ops")
                for t in row["top"]:
                    log(f"    {t['device_ms']:9.3f} ms {t['count']:6d}x {t['name']}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 10: the production planes served by CudaPartitionEngine — the shared
# wave scheduler across partitions with the multi-tenant mix (10a), delta
# snapshots and crash restore (10b), the trace and audit planes (10c)
# ---------------------------------------------------------------------------

# bench.py:501 run_multi_tenant's defaults: 8 partitions picked with Zipf
# weights 1/(r+1)^1.2, seed 7; 24 clients x 16 instances, one worker of 256
# credits, a 60 s cap the instances must finish under. The in-process leg
# spreads 2,048 config-1 instances by the same weights in 8 bursts of 256
PLANES_PARTITIONS = 8
PLANES_ZIPF_S = 1.2
PLANES_SEED = 7
PLANES_INSTANCES = SERVE_INSTANCES
PLANES_BURSTS = 8
PLANES_WAVE = 256
TENANT_CLIENTS = 24
TENANT_INSTANCES = 16
TENANT_DURATION_S = 60
# tools/scheduler_smoke.py's own mix: 4 bursts over 4 partitions, the shared
# drain's mean wave fill at least twice the per-partition baseline's
SMOKE_PARTITIONS = 4
SMOKE_MIX = (0,) * 12 + (1,) * 3 + (2,) * 2 + (3,)
SMOKE_BURSTS = 4
SMOKE_FILL_RATIO = 2.0
# 10b (tools/state_smoke.py at 6a's config-1 width): the worker closed
# before the last 256 instances; credits the tick's backlog pull hands out
# (the small delta: that many instances end, and as many in the tail)
STATE_PARKED = 256
STATE_CREDITS = 16
# 10c
TRACE_INSTANCES = 512
TRACE_LIFECYCLE = ("gateway_recv", "commit", "feed_take", "wave_dispatch", "apply",
                   "response", "exporter_dispatch", "exporter_ack")


def zipf_bursts():
    """PLANES_INSTANCES partition ids drawn with run_multi_tenant's weights,
    in PLANES_BURSTS bursts."""
    import random

    n, bursts, partitions = PLANES_INSTANCES, PLANES_BURSTS, PLANES_PARTITIONS
    rng = random.Random(PLANES_SEED)
    weights = [1.0 / (r + 1) ** PLANES_ZIPF_S for r in range(partitions)]
    pids = [rng.choices(range(partitions), weights=weights)[0] for _ in range(n)]
    per = n // bursts
    return [pids[i * per:(i + 1) * per] for i in range(bursts)]


def _sync(device):
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def _wave_counters():
    from zeebe_tpu_torch.runtime.metrics import GLOBAL_REGISTRY

    names = ("serving_waves_total", "serving_wave_records_total",
             "scheduler_shared_waves_total")
    at = {n: GLOBAL_REGISTRY.counter(n).value for n in names}
    return lambda: {n: GLOBAL_REGISTRY.counter(n).value - at[n] for n in names}


def scheduled_drain(device, workdir, bursts, partitions, use_scheduler):
    """10a's in-process leg: config 1 on ``partitions`` partitions of the
    port's Broker, waves of PLANES_WAVE, one worker of SERVE_CREDITS
    credits; each burst (a list of partition ids) written at once, then one
    drain. Returns each partition's log and frames, the mean wave fill, the
    waves, the wall seconds, and each engine's device records."""
    import itertools

    from zeebe_tpu_torch.gateway import JobWorker, ZeebeClient
    from zeebe_tpu_torch.gateway import workers
    from zeebe_tpu_torch.protocol import codec
    from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI
    from zeebe_tpu_torch.protocol.records import WorkflowInstanceRecord

    workers._subscriber_keys = itertools.count(1)
    broker = _port_broker(device, workdir, partitions=partitions)
    broker.use_scheduler = use_scheduler
    broker.wave_size = PLANES_WAVE
    try:
        ZeebeClient(broker).deploy_model(config1_model())
        JobWorker(broker, "payment-service", lambda ctx: {"paid": True},
                  credits=SERVE_CREDITS)
        counters = _wave_counters()
        _sync(device)
        t0 = time.perf_counter()
        for b, burst in enumerate(bursts):
            for i, pid in enumerate(burst):
                broker.write_command(pid, WorkflowInstanceRecord(
                    bpmn_process_id="order-process", payload={"b": b, "i": i},
                ), WI.CREATE)
            broker.run_until_idle()
        _sync(device)
        wall = time.perf_counter() - t0
        waves = counters()
        logs = [broker.records(pid) for pid in range(partitions)]
        engines = [p.engine for p in broker.partitions]
        left = {pid: sorted(e.job_records_in_flight().items())[:5]
                for pid, e in enumerate(engines)
                if getattr(e, "job_records_in_flight", dict)()}
        if left:
            raise AssertionError(f"10a: job records in flight at rest: {left}")
        return {
            "logs": logs, "frames": [[codec.encode_record(r) for r in log] for log in logs],
            "fill": waves["serving_wave_records_total"] / max(waves["serving_waves_total"], 1),
            "waves": waves["serving_waves_total"],
            "shared_waves": waves["scheduler_shared_waves_total"],
            "wall_seconds": wall,
            "records": sum(len(log) for log in logs),
            "device_records": [getattr(e, "device_records_processed", 0) for e in engines],
            "host_only": [getattr(e, "host_only_reasons", {}) for e in engines],
        }
    finally:
        broker.close()


def scheduling_leg(device, workdir):
    """10a, in process: the smoke's skewed mix, then the full-width Zipf
    bursts, each with the scheduler on and off: every partition's log
    bit-identical between the two, the Zipf run's signatures equal to the
    port's host oracle's, partition 0 device-served. As in the JAX package,
    only the partition whose engine processed the DEPLOYMENT (partition 0)
    compiles the workflow; the others run it on their engine's host oracle
    (ROADMAP Queue 3)."""
    out = {}
    smoke = [list(SMOKE_MIX)] * SMOKE_BURSTS
    zipf = zipf_bursts()
    for label, bursts, partitions in (("smoke", smoke, SMOKE_PARTITIONS),
                                      ("zipf", zipf, PLANES_PARTITIONS)):
        reset_launches()
        shared = scheduled_drain(device, workdir, bursts, partitions, True)
        base = scheduled_drain(device, workdir, bursts, partitions, False)
        launches = launch_counts()
        for pid, (a, b) in enumerate(zip(shared["frames"], base["frames"])):
            if a != b:
                raise AssertionError(f"10a {label}: partition {pid}'s log differs with "
                                     f"the scheduler on and off")
        if shared["device_records"][0] <= 0 or shared["host_only"][0]:
            raise AssertionError(f"10a {label}: partition 0 not device-served "
                                 f"({shared['host_only'][0]})")
        if device == "cuda":
            zero = [k for k in CONFIG1_KERNELS[:3] if launches[k] <= 0]
            if zero:
                raise AssertionError(f"10a {label}: kernels never launched: {zero}")
        run = {
            "partitions": partitions, "instances": sum(map(len, bursts)),
            "per_partition": [sum(b.count(p) for b in bursts) for p in range(partitions)],
            "records": shared["records"], "launches": launches,
            "shared_fill": shared["fill"], "baseline_fill": base["fill"],
            "ratio": shared["fill"] / base["fill"],
            "shared_waves": shared["waves"], "baseline_waves": base["waves"],
            "shared_seconds": shared["wall_seconds"],
            "baseline_seconds": base["wall_seconds"],
            "device_records": shared["device_records"],
        }
        if label == "smoke" and run["ratio"] < SMOKE_FILL_RATIO:
            raise AssertionError(f"10a smoke: shared fill {shared['fill']:.1f} vs baseline "
                                 f"{base['fill']:.1f}, ratio {run['ratio']:.2f} < "
                                 f"{SMOKE_FILL_RATIO}")
        if label == "zipf":
            oracle = scheduled_drain("oracle", workdir, bursts, partitions, True)
            for pid in range(partitions):
                _same_log(f"10a zipf partition {pid}",
                          record_signature(shared["logs"][pid]),
                          record_signature(oracle["logs"][pid]), "card and oracle logs")
            run["oracle_seconds"] = oracle["wall_seconds"]
        out[label] = run
    return out


def multi_tenant(engine_type, workdir, scheduler=True, overload=False, device=None):
    """10a's cluster leg: bench.py:501 ``run_multi_tenant`` on the port, its
    defaults as they are (``BrokerCfg()`` but for the ports the OS picks and
    ``[engine] type``): PLANES_PARTITIONS partitions, TENANT_CLIENTS clients
    each creating TENANT_INSTANCES instances on partitions picked with the
    Zipf weights (their own seeded draws), one worker of 256 credits, every
    partition warmed first; ``scheduler`` off runs the per-partition
    baseline drain, ``overload`` sets bench.py:534-537's admission
    watermarks. Every created instance must complete exactly once inside
    TENANT_DURATION_S seconds. ``device`` pins the engines (the card if
    None). Besides the latencies it counts what the drain did inside the
    timed window: segments (one engine dispatch each: a shared wave's
    partitions, or one per baseline wave) and device rounds (one lookup
    launch each)."""
    import collections
    import random
    import tempfile
    import threading

    from zeebe_tpu_torch.gateway.cluster_client import ClusterClient
    from zeebe_tpu_torch.runtime.cluster_broker import ClusterBroker
    from zeebe_tpu_torch.runtime.engines import engine_factory_from_config
    from zeebe_tpu_torch.runtime.metrics import GLOBAL_REGISTRY

    partitions, clients = PLANES_PARTITIONS, TENANT_CLIENTS
    per_client, duration = TENANT_INSTANCES, TENANT_DURATION_S
    _freeze_heap()
    cfg = _cluster_cfg("tenant-0", engine_type, partitions=partitions)
    cfg.scheduler.enabled = scheduler
    if overload:
        cfg.admission.max_inflight_per_connection = 4
        cfg.admission.queue_depth_high = 64
        cfg.admission.retry_after_ms = 5
    broker = ClusterBroker(cfg, tempfile.mkdtemp(prefix="tenant-", dir=workdir),
                           engine_factory=engine_factory_from_config(cfg, device=device))
    clients_open = []

    def counters():
        c = GLOBAL_REGISTRY.counter
        return {
            "waves": c("serving_waves_total").value,
            "records": c("serving_wave_records_total").value,
            "shared": c("scheduler_shared_waves_total").value,
            "sources": c("scheduler_wave_sources_total").value,
            "rounds": launch_counts()["lookup"],
            "shed_conn": c("gateway_commands_shed", reason="CONNECTION_INFLIGHT").value,
            "shed_queue": c("gateway_commands_shed", reason="QUEUE_DEPTH").value,
        }

    try:
        t_start = time.perf_counter()
        for pid in range(partitions):
            broker.open_partition(pid).join(600)
            broker.bootstrap_partition(pid, {})
        _wait(lambda: all(broker.partitions[p].is_leader for p in range(partitions)),
              600, "leadership of every partition")
        admin = ClusterClient([broker.client_address], num_partitions=partitions,
                              request_timeout_ms=300_000)
        clients_open.append(admin)
        admin.deploy_model(serve_bench_model())
        done_cond = threading.Condition()
        done_at = {}
        pushes = collections.Counter()

        def on_job(pid, rec):
            key = (pid, rec.value.headers.workflow_instance_key)
            with done_cond:
                pushes[key] += 1
                done_at.setdefault(key, time.perf_counter())
                done_cond.notify_all()
            return {}

        worker = admin.open_job_worker("payment-service", on_job, credits=SERVE_CREDITS)
        for pid in range(partitions):  # warm every partition's engine
            admin.create_instance("serve-bench", partition_id=pid)
        with done_cond:
            if not done_cond.wait_for(lambda: len(done_at) >= partitions, timeout=240):
                raise AssertionError(f"10a {engine_type}: the warm-up instances never "
                                     f"completed")
        ready = time.perf_counter() - t_start
        log(f"    10a {engine_type}: {partitions} partitions led and warmed in {ready:.1f} s")
        weights = [1.0 / (r + 1) ** PLANES_ZIPF_S for r in range(partitions)]
        c0 = counters()
        starts, errors = {}, []
        starts_lock = threading.Lock()
        stop_at = time.monotonic() + duration

        def tenant(k):
            rng = random.Random(PLANES_SEED * 1000 + k)
            client = ClusterClient([broker.client_address], num_partitions=partitions,
                                   request_timeout_ms=120_000)
            clients_open.append(client)
            for _ in range(per_client):
                if time.monotonic() > stop_at:
                    return
                pid = rng.choices(range(partitions), weights=weights)[0]
                t_send = time.perf_counter()
                try:
                    rsp = client.create_instance("serve-bench", payload={"t": k},
                                                 partition_id=pid)
                except Exception as e:  # noqa: BLE001 - reported below as a failure
                    errors.append(repr(e)[:200])
                    return
                with starts_lock:
                    starts[(pid, rsp.value.workflow_instance_key)] = t_send

        def all_done():
            with starts_lock:
                pending = list(starts)
            return all(key in done_at for key in pending)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=tenant, args=(k,), daemon=True)
                   for k in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(duration + 120)
        with done_cond:
            done_cond.wait_for(all_done, timeout=max(
                1.0, duration - (time.perf_counter() - t0)))
        elapsed = time.perf_counter() - t0
        c1 = counters()
        want = clients * per_client
        log(f"    10a {engine_type}: {len(starts)} created, {len(done_at) - partitions} "
            f"pushed in {elapsed:.1f} s")
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"10a {engine_type}: tenants failed: {errors[:3]}")
        missing = [k for k in starts if k not in done_at]
        if len(starts) != want or missing or elapsed > duration:
            raise AssertionError(f"10a {engine_type}: {len(starts)} of {want} created, "
                                 f"{len(missing)} not completed in {elapsed:.1f} s "
                                 f"(cap {duration} s)")
        twice = [k for k, n in pushes.items() if n != 1]
        if twice:
            raise AssertionError(f"10a {engine_type}: jobs pushed more than once: "
                                 f"{twice[:5]}")
        # every instance's end is committed, exactly once, partition by
        # partition (the worker still open: its last completions may be on
        # their way)
        kinds, completed = {}, 0
        for pid in range(partitions):
            log_ = broker.partitions[pid].log
            mine = {key for p, key in starts if p == pid}
            try:
                # each poll decodes the partition's log: slowly, to leave the
                # brokers' threads the interpreter
                _wait(lambda: mine <= set(_completions(log_)[0]), 120,
                      f"partition {pid}'s instance ends in its log", interval=0.5)
            except AssertionError:
                done = _completions(log_)[0]
                raise AssertionError(
                    f"10a {engine_type}: partition {pid}'s log ends {len(mine - set(done))}"
                    f" of its {len(mine)} instances nowhere (log at "
                    f"{log_.next_position}, commit {log_.commit_position}, processed to "
                    f"{broker.partitions[pid].next_read_position})") from None
            done, kinds[pid] = _completions(log_)
            if any(done[key] != 1 for key in mine) or len(done) != len(mine) + 1:
                raise AssertionError(f"10a {engine_type}: partition {pid} completed "
                                     f"{len(done)} instances, not once each")
            completed += len(mine)
        log(f"    10a {engine_type}: every end committed "
            f"{time.perf_counter() - t0 - elapsed:.1f} s after the last push")
        worker.close()
        in_flight = _quiet_in_flight(broker, range(partitions), f"10a {engine_type}")
        latencies = sorted(done_at[k] - t for k, t in starts.items())
        d = {k: c1[k] - c0[k] for k in c1}
        out = {
            "engine": engine_type, "scheduler": scheduler, "overload": overload,
            "partitions": partitions, "clients": clients, "instances": len(starts),
            "completed": completed, "ready_seconds": ready, "elapsed_seconds": elapsed,
            "instances_per_sec": len(starts) / elapsed,
            "p50_latency_ms": 1000 * latencies[len(latencies) // 2],
            "p99_latency_ms": 1000 * latencies[min(len(latencies) - 1,
                                                   int(len(latencies) * 0.99))],
            "mean_wave_fill": d["records"] / d["waves"] if d["waves"] else 0.0,
            "waves": d["waves"], "shared_waves": d["shared"], "records": d["records"],
            # a baseline wave is one partition's segment
            "segments": d["sources"] if scheduler else d["waves"],
            "device_rounds": d["rounds"],
            "shed": d["shed_conn"] + d["shed_queue"], "shed_connection": d["shed_conn"],
            "shed_queue_depth": d["shed_queue"], "kinds": kinds,
            "per_partition": [sum(1 for p, _ in starts if p == q) for q in range(partitions)],
            "in_flight_at_rest": in_flight,
        }
        if engine_type == "cuda":
            from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

            # partition 0 processed the DEPLOYMENT: as in the JAX package, only
            # its engine compiled the workflow (ROADMAP Queue 3)
            engines = [broker.partitions[p].engine for p in range(partitions)]
            if not all(isinstance(e, CudaPartitionEngine) for e in engines) or (
                    engines[0].device_records_processed <= 0 or engines[0].host_only_reasons):
                raise AssertionError("10a cuda: partition 0 not device-served")
            out["device_records"] = [e.device_records_processed for e in engines]
            out["host_records"] = [e.host_records_processed for e in engines]
        return out
    finally:
        t_close = time.perf_counter()
        for c in clients_open:
            c.close()
        t_broker = time.perf_counter()
        broker.close()
        log(f"    10a {engine_type}: {len(clients_open)} clients closed in "
            f"{t_broker - t_close:.1f} s, the broker in {time.perf_counter() - t_broker:.1f} s")


def tenants_leg(workdir, device=None):
    """10a's cluster leg: run_multi_tenant shared, baseline and overloaded on
    the card, then on the host oracle: every run completes each instance
    once with the host run's records partition by partition."""
    runs = {}
    for label, engine_type, scheduler, overload in (
        ("shared", "cuda", True, False), ("baseline", "cuda", False, False),
        ("overload", "cuda", True, True), ("host", "host", True, False),
    ):
        reset_launches()
        runs[label] = multi_tenant(engine_type, workdir, scheduler, overload, device=device)
        runs[label]["launches"] = launch_counts()
    host = runs["host"]
    for label in ("shared", "baseline", "overload"):
        run = runs[label]
        if run["per_partition"] != host["per_partition"] or run["kinds"] != host["kinds"]:
            diff = {(p, k): (run["kinds"][p].get(k), host["kinds"][p].get(k))
                    for p in host["kinds"] for k in set(run["kinds"][p]) | set(host["kinds"][p])
                    if run["kinds"][p].get(k) != host["kinds"][p].get(k)}
            raise AssertionError(f"10a {label}: records differ from the host run's "
                                 f"(card, host): {dict(list(diff.items())[:6])}")
    if runs["shared"]["shared_waves"] <= 0 or runs["overload"]["shared_waves"] <= 0:
        raise AssertionError("10a: no shared wave with the scheduler on")
    if runs["overload"]["shed"] <= 0:
        raise AssertionError("10a overload: nothing was shed")
    for run in runs.values():
        run["kinds"] = {f"{p}/" + "/".join(map(str, k)): n
                        for p, ks in run["kinds"].items() for k, n in sorted(ks.items())}
    return runs


def _launched_since(before):
    return {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}


def _take(broker, engine):
    """One snapshot take of partition 0, timed: the controller's stats, the
    device arrays read back and their bytes, and the kernels launched."""
    before = launch_counts()
    t0 = time.perf_counter()
    broker.snapshot()
    seconds = time.perf_counter() - t0
    launches = _launched_since(before)
    stats = dict(broker.partitions[0].snapshots.last_take_stats)
    read = list(engine.last_snapshot_readback)
    return {"seconds": seconds, "new_bytes": stats["new_bytes"],
            "total_bytes": stats["total_bytes"], "parts": stats["parts"],
            "reused_parts": stats["reused_parts"], "readback": read,
            "readback_bytes": _readback_bytes(engine, read), "launches": launches}


def _readback_bytes(engine, names):
    state = engine.state
    total = 0
    for name in names:
        base, _, leaf = name.partition(".")
        value = getattr(state, base)
        total += (getattr(value, leaf) if leaf else value).nbytes
    return total


def _leaf_devices(state):
    """The devices every leaf of an engine state lies on."""
    from zeebe_tpu_torch.tpu import state as state_mod

    devices = set()
    for name in state_mod.STATE_FIELDS:
        value = getattr(state, name)
        for t in (value.keys, value.vals) if name in state_mod.MAP_FIELDS else (value,):
            devices.add(str(t.device))
    return sorted(devices)


def _normalized_parts(engine, drop_subscriptions=False):
    """The engine's snapshot parts with its lookup structures derived from
    the rows as a restore derives them (``rebuild_lookup_state``), and with
    ``drop_subscriptions`` the worker subscriptions left out (session state
    a restore drops)."""
    from zeebe_tpu_torch.log import stateser
    from zeebe_tpu_torch.tpu import state as state_mod

    engine.state = state_mod.rebuild_lookup_state(engine.state)
    parts = dict(stateser.encode_state_parts(engine.snapshot_state()))
    if drop_subscriptions:
        parts = {k: v for k, v in parts.items() if not k.startswith("a/sub_")}
    return parts


def _same_parts(label, a, b):
    if sorted(a) != sorted(b):
        raise AssertionError(f"{label}: other snapshot parts: {sorted(set(a) ^ set(b))}")
    differ = [k for k in a if a[k] != b[k]]
    if differ:
        from zeebe_tpu_torch.protocol import msgpack

        root = ("_root" in differ and (msgpack.unpack(a["_root"]), msgpack.unpack(b["_root"])))
        raise AssertionError(f"{label}: snapshot parts differ: {differ} {str(root)[:2000]}")


def _ended_instances(log_):
    return sum(_completions(log_)[0].values())


def state_leg(device, workdir):
    """10b on ``device``: tools/state_smoke.py at 6a's served config-1 width
    (capacity SERVE_CAPACITY, waves of 256, one worker of SERVE_CREDITS
    credits closed before the last STATE_PARKED instances, whose jobs stay
    parked). A cold take, an idle take, a worker of 0 credits given
    STATE_CREDITS by a tick's backlog pull and a take, those jobs served
    and a take, a message published and a take; another pull served (the
    tail), the live state, and the broker closed. A new broker on the same data directory restores
    from the delta chain and replays the tail; a new worker serves the
    parked jobs to the end. Returns every number and the live state's
    parts (the comparison across devices)."""
    import itertools

    from zeebe_tpu_torch.gateway import JobWorker, ZeebeClient
    from zeebe_tpu_torch.gateway import workers
    from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI
    from zeebe_tpu_torch.protocol.records import WorkflowInstanceRecord
    from zeebe_tpu_torch.runtime import ControlledClock
    import tempfile

    import torch

    from zeebe_tpu_torch.testing.chaos import replay_oracle
    from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

    instances, parked = SERVE_INSTANCES, STATE_PARKED
    workers._subscriber_keys = itertools.count(1)
    clock = ControlledClock(start_ms=1_000_000)

    data_dir = tempfile.mkdtemp(prefix="state-", dir=workdir)
    broker = _port_broker(device, workdir, clock=clock, data_dir=data_dir)
    broker.wave_size = PLANES_WAVE
    log_ = broker.partitions[0].log
    engine = broker.partitions[0].engine

    def burst(n, base):
        for i in range(n):
            broker.write_command(0, WorkflowInstanceRecord(
                bpmn_process_id="order-process", payload=order_payload(base + i),
            ), WI.CREATE)
        broker.run_until_idle()

    out = {"device": device, "instances": instances, "parked": parked}
    client = ZeebeClient(broker)
    client.deploy_model(config1_model())
    first = JobWorker(broker, "payment-service", lambda ctx: {"paid": True},
                      credits=SERVE_CREDITS)
    _sync(device)
    t0 = time.perf_counter()
    burst(instances - parked, 0)
    tick_until_quiet(broker)
    first.close()
    burst(parked, instances - parked)
    _sync(device)
    out["serve_seconds"] = time.perf_counter() - t0
    if _ended_instances(log_) != instances - parked:
        raise AssertionError(f"10b {device}: {_ended_instances(log_)} instances ended "
                             f"before the parked ones, not {instances - parked}")
    late = JobWorker(broker, "payment-service", lambda ctx: {"paid": True}, credits=0)
    out["cold"] = _take(broker, engine)
    out["idle"] = _take(broker, engine)
    # a credit for STATE_CREDITS jobs and the tick's backlog pull: only the
    # subscription table moves
    engine.increase_job_credits(late.subscriber_key, STATE_CREDITS)
    before = log_.next_position
    broker.tick()
    out["pulled"] = log_.next_position - before
    out["tick"] = _take(broker, engine)
    # the pulled jobs served: STATE_CREDITS instances end. Every device
    # family is dirty after a step, and each table array is one
    # content-addressed part
    broker.run_until_idle()
    out["delta"] = _take(broker, engine)
    # tools/state_smoke.py's delta: one message published (config 1 has no
    # message element: the host oracle holds the store)
    client.publish_message("state-evt", "c-1", {"x": 1}, time_to_live_ms=600_000)
    broker.run_until_idle()
    out["publish"] = _take(broker, engine)
    # the tail the restore replays: the served jobs gave their credits back,
    # and the next tick pulls as many parked jobs, served to the end (a tail
    # that ends instances and allocates no row: a restore derives the free
    # rings from the rows, so rows allocated after it land in other slots)
    broker.tick()
    broker.run_until_idle()
    late.close()
    out["ended_live"] = _ended_instances(log_)
    live = _normalized_parts(engine, drop_subscriptions=True)
    out["live_parts"] = dict(_normalized_parts(engine))
    out["live_position"] = engine.last_processed_position
    broker.close()

    from zeebe_tpu_torch.log import stateser

    families = {stateser.device_array_family(n) for n in out["cold"]["readback"]}
    checks = [
        ("the cold take read every device family back",
         families == set(stateser.DEVICE_ARRAY_FAMILIES)),
        ("the idle take read nothing back", out["idle"]["readback"] == []),
        ("the idle take wrote no byte", out["idle"]["new_bytes"] == 0),
        ("the tick pulled STATE_CREDITS jobs", out["pulled"] == STATE_CREDITS),
        ("the tick's take read back only sub_*",
         bool(out["tick"]["readback"])
         and all(n.startswith("sub_") for n in out["tick"]["readback"])),
        ("the publish's take read back only the key counters (the message key is the "
         "host's)", {stateser.device_array_family(n) for n in out["publish"]["readback"]}
         <= {"keys"}),
        ("the publish's take wrote far fewer bytes than the state holds",
         0 < out["publish"]["new_bytes"] < out["publish"]["total_bytes"] // 5),
        ("the few instances' take reused parts and wrote less than the state holds",
         out["delta"]["reused_parts"] > 0
         and 0 < out["delta"]["new_bytes"] < out["delta"]["total_bytes"]),
    ]
    if device == "cuda":
        checks += [(f"the {t} take launched no kernel", not out[t]["launches"])
                   for t in ("cold", "idle", "tick", "publish", "delta")]
    failed = [what for what, ok in checks if not ok]
    if failed:
        raise AssertionError(f"10b {device}: {failed}: " + json.dumps(
            {t: {k: v for k, v in out[t].items() if k != "readback"} | {
                "readback": out[t]["readback"][:8]}
             for t in ("cold", "idle", "tick", "publish", "delta")}))

    # crash-restore: a new broker and engine on the same data directory; the
    # restore's launches counted alone
    restore = {}
    original = CudaPartitionEngine.restore_state

    def counted(self, snap):
        before = launch_counts()
        t = time.perf_counter()
        original(self, snap)
        _sync(device)
        restore["seconds"] = time.perf_counter() - t
        restore["launches"] = _launched_since(before)
        restore["devices"] = _leaf_devices(self.state)

    CudaPartitionEngine.restore_state = counted
    try:
        t0 = time.perf_counter()
        broker = _port_broker(device, workdir, clock=clock, data_dir=data_dir)
        out["reopen_seconds"] = time.perf_counter() - t0
    finally:
        CudaPartitionEngine.restore_state = original
    try:
        log_ = broker.partitions[0].log
        engine = broker.partitions[0].engine
        if "seconds" not in restore:
            raise AssertionError(f"10b {device}: the new engine restored no snapshot")
        out["restore"] = restore
        out["replayed"] = engine.last_processed_position - broker.partitions[0].snapshots \
            .storage.list()[0].last_processed_position
        want = torch.device(engine.device.type, engine.device.index if (
            engine.device.index is not None or engine.device.type != "cuda")
            else torch.cuda.current_device())
        if restore["devices"] != [str(want)]:
            raise AssertionError(f"10b {device}: restored tables on {restore['devices']}, "
                                 f"not the engine's {want}")
        if device == "cuda" and restore["launches"] != {"insert": INSERTS_PER_REBUILD}:
            raise AssertionError(f"10b: the restore launched {restore['launches']}, not "
                                 f"{INSERTS_PER_REBUILD} inserts")
        # the records past the last one a follow-up names were never
        # processed for certain: they are processed now, and write nothing
        before = log_.next_position
        broker.run_until_idle()
        if log_.next_position != before:
            raise AssertionError(f"10b {device}: the restored broker wrote "
                                 f"{log_.next_position - before} records of its own")
        _same_parts(f"10b {device}: the restored and the live state",
                    _normalized_parts(engine, drop_subscriptions=True), live)
        committed = log_.reader(0).read_committed()
        oracle = replay_oracle(committed)
        live_keys = sorted(int(k) for k in engine.state.ei_key[engine.state.ei_state >= 0]
                           .cpu().tolist()) + sorted(engine._host.element_instances.instances)
        if sorted(oracle.element_instances.instances) != sorted(live_keys):
            raise AssertionError(f"10b {device}: the replay oracle's element instances "
                                 f"differ from the restored engine's")
        if oracle.last_processed_position != engine.last_processed_position:
            raise AssertionError(f"10b {device}: the replay oracle at "
                                 f"{oracle.last_processed_position}, the engine at "
                                 f"{engine.last_processed_position}")
        out["oracle_instances"] = len(oracle.element_instances.instances)
        # the restored engine serves the parked jobs to the end
        JobWorker(broker, "payment-service", lambda ctx: {"paid": True},
                  credits=SERVE_CREDITS)
        t0 = time.perf_counter()
        tick_until_quiet(broker)
        out["after_restore_seconds"] = time.perf_counter() - t0
        total = instances
        twice, activates, rejected = _activations(log_)
        if _ended_instances(log_) != total or twice or rejected:
            raise AssertionError(f"10b {device}: {_ended_instances(log_)} of {total} "
                                 f"instances ended; jobs activated twice {twice[:5]}, "
                                 f"{rejected} JOB commands rejected")
        out["activates"] = activates
    finally:
        broker.close()
    return out


def state_phase(workdir):
    """10b on the card, then on the CPU: the live states equal part for part."""
    card = state_leg("cuda", workdir)
    cpu = state_leg("cpu", workdir)
    _same_parts("10b: the card's and the CPU's live state", card.pop("live_parts"),
                cpu.pop("live_parts"))
    card["cpu_serve_seconds"] = cpu["serve_seconds"]
    return card


def traced_serve(device, workdir, traced):
    """10c: TRACE_INSTANCES config-1 instances served on ``device`` with the
    JSONL audit exporter, under a rate-1.0 RecordTracer when ``traced``.
    Returns the tracer, the audit documents, the committed records' audit
    documents read back from the log's segments, and the wall time."""
    import itertools
    import tempfile

    from zeebe_tpu_torch import tracing
    from zeebe_tpu_torch.exporter import read_audit_docs
    from zeebe_tpu_torch.exporter.base import record_to_doc
    from zeebe_tpu_torch.gateway import JobWorker, ZeebeClient
    from zeebe_tpu_torch.gateway import workers
    from zeebe_tpu_torch.log import LogStream, SegmentedLogStorage
    from zeebe_tpu_torch.protocol.enums import ValueType
    from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI
    from zeebe_tpu_torch.protocol.records import WorkflowInstanceRecord
    from zeebe_tpu_torch.runtime.config import ExporterCfg

    workers._subscriber_keys = itertools.count(1)
    root = tempfile.mkdtemp(prefix="trace-", dir=workdir)
    data_dir, audit_dir = os.path.join(root, "data"), os.path.join(root, "audit")
    # every command sampled, and a live-span budget that holds the burst
    tracer = tracing.install(tracing.RecordTracer(
        sample_rate=1.0, seed=11, per_partition_budget=2 * TRACE_INSTANCES)) if traced else None
    try:
        broker = _port_broker(device, workdir, data_dir=data_dir, exporters=[
            ExporterCfg(id="audit", type="jsonl", args={"path": audit_dir})])
        broker.wave_size = PLANES_WAVE
        try:
            ZeebeClient(broker).deploy_model(config1_model())
            JobWorker(broker, "payment-service", lambda ctx: {"paid": True},
                      credits=SERVE_CREDITS)
            _sync(device)
            t0 = time.perf_counter()
            for i in range(TRACE_INSTANCES):
                broker.write_command(0, WorkflowInstanceRecord(
                    bpmn_process_id="order-process", payload=order_payload(i),
                ), WI.CREATE)
            broker.run_until_idle()
            tick_until_quiet(broker)
            _sync(device)
            wall = time.perf_counter() - t0
            records = len(broker.records(0))
            engine = broker.partitions[0].engine
            if engine.device_records_processed <= 0:
                raise AssertionError("10c: no record went through the step kernel")
        finally:
            broker.close()
    finally:
        if traced:
            tracing.install(None)
    storage = SegmentedLogStorage(os.path.join(data_dir, "partition-0"))
    try:
        stream = LogStream(storage)
        committed = [
            json.loads(json.dumps(record_to_doc(r), separators=(",", ":"), sort_keys=True))
            for r in stream.reader(0)
            if r.position <= stream.commit_position
            and int(r.metadata.value_type) != int(ValueType.EXPORTER)
        ]
    finally:
        storage.close()
    return {"tracer": tracer, "docs": read_audit_docs(audit_dir), "committed": committed,
            "wall_seconds": wall, "records": records, "root": root}


def trace_leg(device, workdir):
    """10c: spans with the whole in-process lifecycle in stamp order,
    consistent wave timelines, the dump through tools/trace_report.py (a
    program of its own) into Chrome-trace JSON, the audit directory equal
    to the committed log field by field; the traced run's rate beside an
    untraced one."""
    here = os.path.dirname(os.path.abspath(__file__))
    instances = TRACE_INSTANCES
    run = traced_serve(device, workdir, True)
    plain = traced_serve(device, workdir, False)
    tracer = run.pop("tracer")
    spans = [s for s in tracer.spans() if "response" in s.stage_names()]
    bad = []
    for span in spans:
        names = span.stage_names()
        ts = [t for _n, t, _f in span.stages]
        if any(s not in names for s in TRACE_LIFECYCLE) or ts != sorted(ts):
            bad.append((span.trace_id, names))
    if len(spans) < instances or bad or tracer.stats()["dropped"]:
        raise AssertionError(f"10c: {len(spans)} complete spans of {instances}; "
                             f"incomplete or out of order: {bad[:3]}")
    waves = tracer.waves.snapshot()
    segments = [seg for w in waves for seg in w["segments"]]
    inconsistent = [w["wave_id"] for w in waves
                    if w["records"] != sum(s["records"] for s in w["segments"])
                    or any(s["t_collect_us"] < s["t_dispatch_us"] for s in w["segments"])]
    device_s = sum(s["device_s"] for s in segments)
    if not waves or inconsistent or sum(w["records"] for w in waves) != run["records"]:
        raise AssertionError(f"10c: wave timelines inconsistent: {inconsistent[:5]}, "
                             f"{sum(w['records'] for w in waves)} records of "
                             f"{run['records']}")
    if device == "cuda" and device_s <= 0:
        raise AssertionError("10c: no device seconds on the wave timelines")
    dump = os.path.join(run["root"], "dump.json")
    chrome_path = os.path.join(run["root"], "chrome.json")
    tracer.dump(dump)
    subprocess.run([sys.executable, os.path.join(here, "tools", "trace_report.py"), dump,
                    "-o", chrome_path], check=True, timeout=300, capture_output=True)
    with open(chrome_path) as f:
        chrome = json.load(f)
    pids = {e["pid"] for e in chrome["traceEvents"]}
    if not {"records", "devices"} <= pids:
        raise AssertionError(f"10c: the Chrome trace holds tracks of {pids}")
    docs, committed = run["docs"], run["committed"]
    key = ("position", "recordType", "valueType", "intent")
    if [tuple(d[k] for k in key) for d in docs] != [tuple(d[k] for k in key)
                                                   for d in committed]:
        raise AssertionError(f"10c: the audit's records ({len(docs)}) are not the "
                             f"log's ({len(committed)})")
    # field by field; the one exception is the reference's: the host oracle
    # fills the DEPLOYMENT command's deployedWorkflows in the Record object
    # it was appended as, and the exporter reads that object
    differ = [(a, b) for a, b in zip(docs, committed) if a != b]
    if [(a["valueType"], a["recordType"]) for a, _ in differ] != [("DEPLOYMENT", "COMMAND")] \
            or {**differ[0][0]["value"], "deployedWorkflows": []} != differ[0][1]["value"]:
        raise AssertionError(f"10c: audit documents differ from the log: "
                             f"{[(a['position'], a['valueType']) for a, _ in differ][:5]}")
    return {
        "instances": instances, "records": run["records"], "spans": len(spans),
        "waves": len(waves), "segments": len(segments), "device_seconds": device_s,
        "host_seconds": sum(s["host_s"] for s in segments),
        "chrome_events": len(chrome["traceEvents"]), "audit_records": len(docs),
        "traced_seconds": run["wall_seconds"], "untraced_seconds": plain["wall_seconds"],
        "traced_records_per_sec": run["records"] / run["wall_seconds"],
        "untraced_records_per_sec": plain["records"] / plain["wall_seconds"],
    }


def planes_phase(here, report, by_path):
    """Phase 10 (10a, 10b, 10c), each path's launches counted from 0."""
    import shutil
    import tempfile

    workdir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="planes-", dir=workdir)
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        sched = scheduling_leg("cuda", workdir)
        report["planes_scheduling"] = sched
        for label in ("smoke", "zipf"):
            run = sched[label]
            by_path[f"planes_{label}"] = run["launches"]
            log(f"[10a] {label}: {run['instances']} config-1 instances over "
                f"{run['partitions']} partitions {run['per_partition']}, waves of "
                f"{PLANES_WAVE}: every partition's log bit-identical with the scheduler on "
                f"and off, partition 0 device-served ({run['device_records']} device "
                f"records); mean wave fill shared {run['shared_fill']:.2f} "
                f"({run['shared_waves']:.0f} waves, {run['shared_seconds']:.3f} s) vs "
                f"baseline {run['baseline_fill']:.2f} ({run['baseline_waves']:.0f} waves, "
                f"{run['baseline_seconds']:.3f} s): ratio {run['ratio']:.3f}"
                + (f"; signatures equal to the port's host oracle's "
                   f"({run['oracle_seconds']:.3f} s)" if "oracle_seconds" in run else "")
                + f"; no job record in flight at rest; launches {run['launches']}")
        log(f"[10a] in process: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        tenants = tenants_leg(workdir)
        report["planes_multi_tenant"] = tenants
        by_path["planes_tenants"] = {
            k: sum(tenants[r]["launches"][k] for r in ("shared", "baseline", "overload"))
            for k in tenants["shared"]["launches"]}
        zero = [k for k in CONFIG1_KERNELS[:3] if by_path["planes_tenants"][k] <= 0]
        if zero:
            raise AssertionError(f"10a multi-tenant: kernels never launched: {zero}")
        for label, run in tenants.items():
            log(f"[10a] multi-tenant {label} ({run['engine']}, scheduler "
                f"{'on' if run['scheduler'] else 'off'}"
                + (", overload watermarks" if run["overload"] else "") + f"): "
                f"{run['instances']} instances from {run['clients']} clients over "
                f"{run['partitions']} partitions {run['per_partition']}, each completed "
                f"once in {run['elapsed_seconds']:.3f} s (ready in "
                f"{run['ready_seconds']:.3f} s) = {run['instances_per_sec']:.1f} "
                f"instances/s; p50 {run['p50_latency_ms']:.1f} ms, p99 "
                f"{run['p99_latency_ms']:.1f} ms; mean wave fill "
                f"{run['mean_wave_fill']:.2f}, {run['waves']:.0f} waves, "
                f"{run['shared_waves']:.0f} shared, {run['segments']:.0f} segments "
                f"({run['records'] / max(run['segments'], 1):.2f} records a segment), "
                f"{run['device_rounds']} device rounds"
                + (f" (device records {run['device_records']}, host records "
                   f"{run['host_records']})" if "device_records" in run else "")
                + f"; shed {run['shed']:.0f} (connection {run['shed_connection']:.0f}, "
                f"queue depth {run['shed_queue_depth']:.0f}); job records in flight at "
                f"rest {run['in_flight_at_rest']}")
        log(f"[10a] multi-tenant: every card run wrote the host run's records partition by "
            f"partition ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        reset_launches()
        state = state_phase(workdir)
        by_path["planes_state"] = launch_counts()
        zero = [k for k in CONFIG1_KERNELS if by_path["planes_state"][k] <= 0]
        if zero:
            raise AssertionError(f"10b: kernels never launched: {zero}")
        report["planes_state"] = state
        for t in ("cold", "idle", "tick", "publish", "delta"):
            take = state[t]
            log(f"[10b] {t} take: {take['seconds']:.4f} s, {take['new_bytes']} new bytes of "
                f"{take['total_bytes']}, {take['reused_parts']}/{take['parts']} parts "
                f"reused, read back {len(take['readback'])} arrays "
                f"({take['readback_bytes']} B), launches {take['launches'] or 0}")
        log(f"[10b] {state['instances']} instances ({state['parked']} parked) served in "
            f"{state['serve_seconds']:.3f} s (cpu {state['cpu_serve_seconds']:.3f} s); the "
            f"tick pulled {state['pulled']} jobs; crash-restore: reopened in "
            f"{state['reopen_seconds']:.3f} s, the restore {state['restore']['seconds']:.4f} "
            f"s with launches {state['restore']['launches']} on "
            f"{state['restore']['devices']}, {state['replayed']} records replayed; the "
            f"restored state equal to the live one and to the CPU's, part for part; the "
            f"replay oracle's {state['oracle_instances']} element instances and position "
            f"equal; the parked jobs served to the end in "
            f"{state['after_restore_seconds']:.3f} s, {state['activates']} activations, "
            f"none twice ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        reset_launches()
        trace = trace_leg("cuda", workdir)
        by_path["planes_trace"] = launch_counts()
        zero = [k for k in CONFIG1_KERNELS[:3] if by_path["planes_trace"][k] <= 0]
        if zero:
            raise AssertionError(f"10c: kernels never launched: {zero}")
        report["planes_trace"] = trace
        log(f"[10c] {trace['instances']} instances traced at rate 1.0 with the JSONL "
            f"exporter: {trace['spans']} spans with the {len(TRACE_LIFECYCLE)}-stage "
            f"lifecycle in stamp order; {trace['waves']} wave timelines consistent "
            f"({trace['segments']} segments, host {trace['host_seconds']:.3f} s, device "
            f"{trace['device_seconds']:.3f} s); {trace['chrome_events']} Chrome-trace "
            f"events through tools/trace_report.py; the audit's {trace['audit_records']} "
            f"records equal to the log field by field; traced "
            f"{trace['traced_records_per_sec']:.1f} records/s vs untraced "
            f"{trace['untraced_records_per_sec']:.1f} ({time.perf_counter() - t0:.1f} s)")
        report["planes_seconds"] = time.perf_counter() - t_phase
        log(f"[10] phase 10 in {report['planes_seconds']:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 11: the drive's step replayed as a CUDA graph (tpu/capture.py)
# ---------------------------------------------------------------------------

# a lookup-rebuild period of waves (rebuilt after waves 0 and 3) and of the
# benchmark's units (after units 0 and 3)
CAPTURE_WAVES = 4
CAPTURE_SEED = 2**33 + 17
# -(2^64 / golden ratio), as a signed int64: the digest's lane weight
_DIGEST_MUL = -7046029254386353131


def _digest(tensors):
    """One int64 device scalar of the tensors' values, lane by lane (the
    bits of a float): equal tensors give equal digests."""
    import torch

    h = None
    for t in tensors:
        v = t.reshape(-1)
        if v.dtype == torch.float32:
            v = v.view(torch.int32)
        v = v.to(torch.int64)
        w = torch.arange(1, v.numel() + 1, dtype=torch.int64, device=v.device) * _DIGEST_MUL
        d = (v * (w | 1)).sum() + v.numel()
        h = d if h is None else h * 1000003 + d
    return h


class _RoundDigests:
    """Wraps the drive's step: the digest of each round's emissions and
    stats, in the drive's order."""

    def __init__(self, step):
        self.step, self.rounds = step, []

    def __call__(self, *args, **kwargs):
        from zeebe_tpu_torch.tpu import batch as rb

        state, out, stats = self.step(*args, **kwargs)
        self.rounds.append(_digest([getattr(out, f) for f in rb.FIELDS]
                                   + [stats[k] for k in sorted(stats)]))
        return state, out, stats


def _state_digests(states):
    """Each state tensor's digest (a list of states: partition by partition)."""
    import torch

    from zeebe_tpu_torch.tpu import capture

    return [int(x) for x in torch.stack(
        [_digest([t]) for st in states for t in capture._leaves(st)]).cpu().tolist()]


def _in_mode(mode, fn):
    """``fn()`` with the drive stepping ``kernel.step_kernel`` (``eager``) or
    ``capture.step`` (``captured``), from no held graph; returns (its
    result, the rounds' digests, ``capture.counts()``, seconds)."""
    import gc

    import torch

    from zeebe_tpu_torch.tpu import capture, drive, kernel

    capture.release()
    tap = _RoundDigests(capture.step if mode == "captured" else kernel.step_kernel)
    saved = drive.step_kernel
    drive.step_kernel = tap
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        drive.step_kernel = saved
    seconds = time.perf_counter() - t0
    rounds = [int(x) for x in torch.stack(tap.rounds).cpu().tolist()] if tap.rounds else []
    counts = capture.counts()
    capture.release()
    gc.collect()
    torch.cuda.empty_cache()
    return out, rounds, counts, seconds


def _modes_agree(label, run, rebuilds, captures=1):
    """``run()`` eagerly and captured: (totals, state digests) and every
    round's digest bit-equal; the captured run captured ``captures`` graphs
    and replayed every other round, rebinding after each of ``rebuilds``."""
    got = {mode: _in_mode(mode, run) for mode in ("eager", "captured")}
    (e_out, e_rounds, _c, e_s), (c_out, c_rounds, counts, c_s) = got["eager"], got["captured"]
    if e_out[0] != c_out[0]:
        raise AssertionError(f"11 {label}: totals eager {e_out[0]}, captured {c_out[0]}")
    if e_rounds != c_rounds:
        bad = [i for i, (a, b) in enumerate(zip(e_rounds, c_rounds)) if a != b]
        raise AssertionError(f"11 {label}: {len(e_rounds)} / {len(c_rounds)} rounds; "
                             f"rounds {bad[:8]} emit other records captured")
    if e_out[1] != c_out[1]:
        bad = [i for i, (a, b) in enumerate(zip(e_out[1], c_out[1])) if a != b]
        raise AssertionError(f"11 {label}: the captured drive left other tables "
                             f"(state tensors {bad[:8]}, STATE_FIELDS order)")
    want = {"captures": captures, "replays": len(c_rounds) - captures, "rebinds": rebuilds,
            "eager": {"cpu": 0, "wrapped_op": 0, "recorder": 0, "signature": captures}}
    if counts != want:
        raise AssertionError(f"11 {label}: CAPTURE {counts}, want {want}")
    return {"rounds": len(c_rounds), "eager_seconds": e_s, "captured_seconds": c_s,
            "capture": counts}


def capture_configs(wave=WAVE, waves=CAPTURE_WAVES, device="cuda"):
    """Configs 1-5 at ``wave``, a rebuild period of waves each: the captured
    drive against the eager one."""
    rows = {}
    for label, drive_fn in (
        ("config1", functools.partial(drive_config, model_fn=config1_model)),
        ("config3", functools.partial(drive_config, model_fn=config3_model)),
        ("config2", functools.partial(drive_config, model_fn=config2_model, mixed=True)),
        ("config4", c4_drive),
        ("config5", config5_drive),
    ):
        def run(drive_fn=drive_fn):
            state, totals, _s = drive_fn(waves, wave, device)
            return totals, _state_digests([state])

        rows[label] = _modes_agree(label, run, rebuilds=1)
    return rows


def capture_cells(units=CAPTURE_WAVES, seed=CAPTURE_SEED, device="cuda", mixes=None):
    """The benchmark's two cells (2^20 a unit) over a rebuild period of
    units, through ``gpubench.run.Runner``: the captured drive against the
    eager one (totals, the five tables' digests after every phase, the key
    counters and credits, every round's emissions). ``mixes`` (cell → mix
    parameters) replaces the cells' traffic: a smaller size off the card."""
    from gpubench import run as bench

    rows = {}
    for name in ("order-process-1p.burst-1m", "message-timer-1p.burst-1m"):
        cell, config, _e, _p = bench.load_cell(name)

        def run(cell=cell, config=config):
            runner = bench.Runner(cell, config, seed, device, (mixes or {}).get(cell["name"]))
            try:
                recs = [runner.unit(u) for u in range(units)]
                runner.sync()
                tables = [[int(x) for st in r.states for name in bench.STATE_TABLES
                           for x in st[name]] for r in recs]
                return ([r.totals for r in recs],
                        [tables, [r.scalars.cpu().tolist() for r in recs]])
            finally:
                runner.tap.close()

        rows[name] = _modes_agree(name, run, rebuilds=1)
    return rows


def capture_mesh(wave=WAVE, places=2, devs=None):
    """``shard.build_sharded_drive`` over ``places`` places (config 1, the
    partitions independent; ``devs``, by default ``mesh_devices``): a graph
    for each place, captured against eager."""
    from zeebe_tpu_torch.tpu import drive, shard

    devs = devs or mesh_devices(places)

    def run():
        graph, meta = config_graph(devs[0], config1_model)
        states = shard.make_partitioned_state(places, CAP_FACTOR * wave, graph.num_vars,
                                              devices=devs, job_capacity=CAP_FACTOR * wave,
                                              sub_capacity=8)
        for st in states:
            st.sub_key[0] = 1
            st.sub_type[0] = meta.interns.intern("payment-service")
            st.sub_worker[0] = meta.interns.intern("bench-worker")
            st.sub_credits[0] = 2**31 - 1
            st.sub_timeout[0] = 300_000
            st.sub_valid[0] = True
        queues = shard.make_partitioned_queue(places, 4 * wave * max(2, graph.emit_width),
                                              graph.num_vars, devices=devs)
        drive_fn = shard.build_sharded_drive(shard.Mesh(devs), wave, synthetic_workers=True)
        totals = []
        for _w in range(2):
            for p in range(places):
                creates = config_creates(meta, wave, graph.num_vars, devs[p])
                queues[p] = drive.enqueue(queues[p], creates)
            states, queues, t = drive_fn(graph, states, queues, 0)
            totals.append([{k: int(v) for k, v in tp.items()} for tp in t])
        return totals, _state_digests(states)

    row = _modes_agree(f"mesh over {[str(d) for d in devs]}", run, rebuilds=0,
                       captures=places)
    row["devices"] = [str(d) for d in devs]
    return row


def capture_hazard(dev="cuda", rows=1 << 12, width=8, b=WAVE, buckets=1 << 16):
    """A captured table commit (an unmasked and a lane-masked set into one
    table, their slots piled onto 64 rows) and insert, replayed twice with
    other data, eager inserts and a commit advancing the card's claim
    epochs between: bit-equal to the plain versions. The same graph
    recorded on the card's own claim scratch must differ (the claim-epoch
    hazard the graph's own scratch removes)."""
    import torch

    from zeebe_tpu_torch.tpu import capture, hashmap, ops

    gen = torch.Generator().manual_seed(29)
    base = torch.randint(-1000, 1000, (rows, width), generator=gen, dtype=torch.int32).to(dev)
    held = torch.randperm(1 << 24, generator=gen)[: 3 * b].to(torch.int64) * 5 + 3
    base_map = _filled_map(dev, gen, held[:b].to(dev), buckets)
    s = {"slots": torch.zeros(b, dtype=torch.int32, device=dev),
         "active": torch.zeros(b, dtype=torch.bool, device=dev),
         "vals": torch.zeros((b, width), dtype=torch.int32, device=dev),
         "slots2": torch.zeros(b, dtype=torch.int32, device=dev),
         "active2": torch.zeros(b, dtype=torch.bool, device=dev),
         "vals2": torch.zeros((b, width), dtype=torch.int32, device=dev),
         "mask2": torch.zeros((b, width), dtype=torch.bool, device=dev),
         "keys": torch.zeros(b, dtype=torch.int64, device=dev),
         "kvals": torch.zeros(b, dtype=torch.int32, device=dev),
         "valid": torch.zeros(b, dtype=torch.bool, device=dev)}

    def fill(trial):
        g = torch.Generator().manual_seed(100 + trial)
        s["slots"].copy_(torch.randint(0, 64, (b,), generator=g, dtype=torch.int32))
        s["active"].copy_(torch.rand((b,), generator=g) < 0.7)
        s["vals"].copy_(torch.randint(-9, 9, (b, width), generator=g, dtype=torch.int32))
        s["slots2"].copy_(torch.randint(0, 64, (b,), generator=g, dtype=torch.int32))
        s["active2"].copy_(torch.rand((b,), generator=g) < 0.7)
        s["vals2"].copy_(torch.randint(-9, 9, (b, width), generator=g, dtype=torch.int32))
        s["mask2"].copy_(torch.rand((b, width), generator=g) < 0.5)
        s["keys"].copy_(held[b + trial * (b // 2): b + trial * (b // 2) + b])
        s["kvals"].copy_(torch.arange(b, dtype=torch.int32) + trial)
        s["valid"].copy_(torch.rand((b,), generator=g) < 0.8)

    def table_ops():
        return [ops.TableOp(0, "set", s["slots"], s["active"], s["vals"]),
                ops.TableOp(0, "set", s["slots2"], s["active2"], s["vals2"], s["mask2"])]

    def plain():
        tbl = ops.fused_table_commit_reference([base.clone()], table_ops())[0]
        table, ok = hashmap.insert(base_map, s["keys"], s["kvals"], s["valid"])
        return tbl, table, ok

    tbl = base.clone()
    table = hashmap.HashTable(base_map.keys.clone(), base_map.vals.clone())

    def body():
        ops.fused_table_commit([tbl], table_ops())
        return ops.insert(table, s["keys"], s["kvals"], s["valid"])[1]

    other = hashmap.make(buckets, device=dev)
    other_tbl = base.clone()

    def eager_between(trial):
        keys = held[2 * b:] + 10 * (trial + 1)
        for i in range(3):  # 3 x MAX_PROBES epochs, over the same scratch words
            part = keys[i * (b // 4): (i + 1) * (b // 4)].to(dev)
            ops.insert(other, part, torch.arange(part.shape[0], dtype=torch.int32, device=dev),
                       torch.ones(part.shape[0], dtype=torch.bool, device=dev))
        ops.fused_table_commit([other_tbl], table_ops())

    fill(0)
    body()  # kernels built, the card's scratch allocated
    tbl.copy_(base)
    table.keys.copy_(base_map.keys)
    table.vals.copy_(base_map.vals)
    torch.cuda.synchronize()
    replay, ok, _launched = capture.record(body, torch.device(dev))
    shared = torch.cuda.CUDAGraph()
    with torch.cuda.graph(shared):  # the card's own claim scratch
        ok_shared = body()

    def replayed(run, ok_out):
        diffs = []
        for trial in (1, 2):
            eager_between(trial)
            fill(trial)
            tbl.copy_(base)
            table.keys.copy_(base_map.keys)
            table.vals.copy_(base_map.vals)
            run()
            want_tbl, want_map, want_ok = plain()
            torch.cuda.synchronize()
            diffs.append(int((tbl != want_tbl).sum()) + int((table.keys != want_map.keys).sum())
                         + int((table.vals != want_map.vals).sum())
                         + int((ok_out != want_ok).sum()))
        return diffs

    own = replayed(replay, ok)
    card = replayed(shared.replay, ok_shared)
    if any(own):
        raise AssertionError(f"11 hazard: the captured commit and insert differ from the "
                             f"plain versions in {own} cells (replays 1, 2)")
    if not any(card):
        raise AssertionError("11 hazard: recorded on the card's own claim scratch, the "
                             "replays still matched: the case does not reach the hazard")
    return {"own_scratch_diffs": own, "card_scratch_diffs": card}


def capture_phase(report):
    """Phase 11: the hazard, configs 1-5 at wave 2^14, the mesh's drive, and
    both benchmark cells at 2^20, captured against eager."""
    t0 = time.perf_counter()
    hz = capture_hazard()
    report["capture_hazard"] = hz
    log(f"[11] hazard: a captured commit and insert replayed twice with other data and "
        f"eager inserts between: bit-equal to the plain versions; recorded on the card's "
        f"own claim scratch they differ in {hz['card_scratch_diffs']} cells "
        f"({time.perf_counter() - t0:.1f} s)")
    for label, row in capture_configs().items():
        report["capture_" + label] = row
        log(f"[11] {label}, {CAPTURE_WAVES} waves of {WAVE}: captured == eager, every "
            f"round's emissions and every table; {row['rounds']} rounds; CAPTURE "
            f"{row['capture']}; eager {row['eager_seconds']:.2f} s, captured "
            f"{row['captured_seconds']:.2f} s")
    row = capture_mesh()
    report["capture_mesh"] = row
    log(f"[11] build_sharded_drive over {row['devices']}: a graph a place, captured == "
        f"eager; CAPTURE {row['capture']}")
    for name, row in capture_cells().items():
        report["capture_" + name] = row
        log(f"[11] {name}, {CAPTURE_WAVES} units: captured == eager (totals, tables after "
            f"every phase, counters, every round's emissions); {row['rounds']} rounds; "
            f"CAPTURE {row['capture']}; eager {row['eager_seconds']:.2f} s, captured "
            f"{row['captured_seconds']:.2f} s")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every measured number here (JSON)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one full-width wave (torch.profiler)")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--hash-only", action="store_true",
                      help="only build and run phase 2's lookup, insert, delete and "
                           "probe cases")
    only.add_argument("--scatter-only", action="store_true",
                      help="only build and run phase 2's scatter and row-loop cases, "
                           "and time the one-op accumulate wrapper piece by piece")
    only.add_argument("--mesh-only", action="store_true",
                      help="only build the kernels and run phase 9 (the mesh)")
    only.add_argument("--planes-only", action="store_true",
                      help="only build the kernels and run phase 10 (the scheduler, "
                           "snapshot, trace and audit planes)")
    only.add_argument("--capture-only", action="store_true",
                      help="only build the kernels and run phase 11 (the drive's "
                           "step replayed as a CUDA graph, against the eager step)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from zeebe_tpu_torch import _build
        from zeebe_tpu_torch.tpu import ops
    except ImportError as e:
        print(f"chip_smoke: the zeebe_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2

    t_script = time.perf_counter()
    report = {}
    smi = smi_line()
    log(f"[0] card: {smi}")
    log(f"    torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[1] {len(_build.SOURCES)} kernel libraries built in {build_s:.2f} s "
        f"(nvcc wall {_build.last_build_seconds:.2f} s)")
    for name, out in _build.ptxas_reports.items():
        for line in out.splitlines():
            if "registers" in line or "error" in line.lower():
                log(f"    {name}: {line.strip()}")
    report["build_seconds"] = build_s

    kernels = []
    checks = (check_gather, check_commit, check_lookup, check_scatters,
              check_insert, check_delete, check_row_loop, check_probe)
    for k, check in enumerate(checks):
        if args.mesh_only or args.planes_only or args.capture_only:
            break
        if args.hash_only and check not in (check_lookup, check_insert, check_delete,
                                            check_probe):
            continue
        if args.scatter_only and check not in (check_scatters, check_row_loop):
            continue
        # a generator of its own: a check's data is the same in every mode
        rows = check("cuda", torch.Generator().manual_seed(1234 + k))
        for row in rows if isinstance(rows, list) else [rows]:
            kernels.append(row)
            log(f"[2] {row['name']}: bit-equal to plain ({row['shape']}); "
                f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                f"library {row['library_ms']}, bound {row['bound_ms']:.4f} ms")
            if "device_us" in row:
                log(f"    device {row['device_us']:.2f} us in {row['device_launches']} "
                    f"launches (back to back), wrapper host {row['host_us']:.2f} us"
                    + (f"; library device {row['library_device_us']:.2f} us, host "
                       f"{row['library_host_us']:.2f} us" if "library_device_us" in row
                       else "")
                    + (f", outputs allocated per op {row['alloc_us']['per_op']:.2f} us"
                       f" / as one arena {row['alloc_us']['arena']:.2f} us"
                       if "alloc_us" in row else ""))
            for extra in ("rounds", "rebuild", "main_path", "walk", "fused", "pair",
                          "passes_us"):
                if extra in row:
                    log(f"    {extra}: {json.dumps(row[extra])}")
            for extra in ("ms_w10", "ms_script_table"):
                if extra in row:
                    log(f"    {extra}: kernel {row[extra]:.4f} ms")

    if not (args.hash_only or args.scatter_only or args.mesh_only or args.planes_only
            or args.capture_only):
        report["two_threads"] = check_two_threads("cuda")
        tt = report["two_threads"]
        log(f"[2] two threads, tables of their own, {tt['commits']} table commits and "
            f"{tt['inserts']} inserts at once: bit-equal to the serial run "
            f"({tt['threaded_seconds']:.3f} s threaded, {tt['serial_seconds']:.3f} s serial)")

    if args.hash_only or args.scatter_only:
        result = {"card": smi, "package": ops.__file__, "kernels": kernels}
        if args.scatter_only:
            result["accumulate_host_ns"] = accumulate_host_pieces(
                "cuda", torch.Generator().manual_seed(5))
            log(f"[2] one-op accumulate host ns: {json.dumps(result['accumulate_host_ns'])}")
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        print(smi, flush=True)
        return 0
    if args.mesh_only or args.planes_only or args.capture_only:
        if args.mesh_only:
            mesh_phase(here, report, {}, args.profile)
        elif args.planes_only:
            planes_phase(here, report, {})
        else:
            capture_phase(report)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1, default=str)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0

    t0 = time.perf_counter()
    ptot = parity()
    log(f"[3] config 1, 3 waves x 1024 at capacity 4096: cuda == cpu, bit-equal "
        f"state and totals {ptot} ({time.perf_counter() - t0:.1f} s)")
    report["parity_totals"] = ptot
    t0 = time.perf_counter()
    ptot3 = parity(model_fn=config3_model, per_instance=TRANSITIONS_PER_INSTANCE_C3,
                   rebuild_every=1)
    log(f"[3] config 3, 3 waves x 1024 at capacity 4096, rebuilt after every "
        f"wave: cuda == cpu, bit-equal state and totals {ptot3} "
        f"({time.perf_counter() - t0:.1f} s)")
    report["parity_totals_config3"] = ptot3
    t0 = time.perf_counter()
    ptot2 = parity(model_fn=config2_model, per_instance=TRANSITIONS_PER_INSTANCE_C2,
                   mixed=True, per_stopped=TRANSITIONS_CONDITION_INCIDENT)
    log(f"[3] config 2, 3 waves x 1024 at capacity 4096, orderValue 10 / 99 / "
        f"absent: cuda == cpu, bit-equal state and totals {ptot2} "
        f"({time.perf_counter() - t0:.1f} s)")
    report["parity_totals_config2"] = ptot2
    t0 = time.perf_counter()
    ptotm = parity(model_fn=mapping_model, per_instance=MAPPING_PER_INSTANCE,
                   mixed=True, per_stopped=MAPPING_PER_STOPPED)
    log(f"[3] I/O-mapping graph, 3 waves x 1024 at capacity 4096 (missing "
        f"source: incident): cuda == cpu, bit-equal state and totals {ptotm} "
        f"({time.perf_counter() - t0:.1f} s)")
    report["parity_totals_mapping"] = ptotm
    mstats = parity_mixed()
    log(f"[3] one mixed step (job commands/events, timer commands, WI events), "
        f"B=4096 at capacity 8192: cuda == cpu, bit-equal state, emissions "
        f"and stats {mstats}")
    tstats = parity_timer_step()
    log(f"[3] one timer step (CREATE, TRIGGER found / unknown, duplicate "
        f"CANCELs), B=4096 with 200 live timers: cuda == cpu, bit-equal "
        f"state, emissions and stats {tstats}")
    counts = oracle_counts()
    want = {"config4_correlated": C4_PER_CORRELATED, "config4_expired": C4_PER_EXPIRED,
            "config4_waiting": C4_PER_WAITING, "config5": TRANSITIONS_PER_INSTANCE_C5}
    if counts != want:
        raise AssertionError(f"the host oracle's records per instance {counts} != {want}")
    log(f"[3] the port's host oracle: {counts} records per instance (a correlated and an "
        f"expired config-4 instance, one up to its wait, a config-5 instance)")
    report["oracle_counts"] = counts
    t0 = time.perf_counter()
    ptot4 = parity(drive=c4_drive, per_instance=(C4_PER_CORRELATED + C4_PER_EXPIRED) / 2)
    log(f"[3] config 4, 3 waves x 1024 (CREATE, PUBLISH for the even half, the "
        f"tick 31 s later): cuda == cpu, bit-equal state and totals {ptot4} "
        f"({time.perf_counter() - t0:.1f} s)")
    report["parity_totals_config4"] = ptot4
    t0 = time.perf_counter()
    pwave4 = parity_c4_wave()
    log(f"[3] config 4, one wave of {WAVE} at capacity {4 * WAVE} (the main path's "
        f"launch shapes): cuda == cpu, bit-equal state before any rebuild and the "
        f"CREATE / PUBLISH / tick drives' totals {pwave4} "
        f"({time.perf_counter() - t0:.1f} s)")
    report["parity_wave_config4"] = pwave4
    t0 = time.perf_counter()
    ptot5 = parity(drive=config5_drive, per_instance=TRANSITIONS_PER_INSTANCE_C5)
    log(f"[3] config 5, 3 waves x 1024 at capacity {CAP_FACTOR_C5 * 1024}: cuda == "
        f"cpu, bit-equal state and totals {ptot5} ({time.perf_counter() - t0:.1f} s)")
    report["parity_totals_config5"] = ptot5
    ticks = parity_tick()
    log(f"[3] tick_kernel on a config-4 state (1024 due timers) and on the mixed "
        f"step's state (due jobs): cuda == cpu, bit-equal batches, due {ticks}")
    report["parity_tick"] = ticks

    by_path = {}
    for phase, label, drive, instances, wave, capacity, per_instance, path in (
        ("4", "config1", functools.partial(drive_config, model_fn=config1_model),
         INSTANCES, WAVE, CAP_FACTOR * WAVE, TRANSITIONS_PER_INSTANCE, CONFIG1_KERNELS),
        ("5", "config3", functools.partial(drive_config, model_fn=config3_model),
         INSTANCES_C3, WAVE, CAP_FACTOR * WAVE, TRANSITIONS_PER_INSTANCE_C3,
         CONFIG3_KERNELS),
        ("5b", "config2", functools.partial(drive_config, model_fn=config2_model),
         INSTANCES_C2, WAVE, CAP_FACTOR * WAVE, TRANSITIONS_PER_INSTANCE_C2,
         CONFIG1_KERNELS),
        ("5c", "config4", c4_drive, INSTANCES_C4, WAVE, 4 * WAVE,
         (C4_PER_CORRELATED + C4_PER_EXPIRED) / 2, CONFIG4_KERNELS),
        ("5d", "config5", config5_drive, INSTANCES_C5, WAVE_C5, CAP_FACTOR_C5 * WAVE_C5,
         TRANSITIONS_PER_INSTANCE_C5, CONFIG5_KERNELS),
    ):
        run = drive_path(label, drive, instances, wave, per_instance, path)
        report[label] = run
        by_path[label] = run["launches"]
        log(f"[{phase}] {label}: {instances} instances, wave {wave}, capacity "
            f"{capacity}: processed {run['totals']['processed']}, completed "
            f"{run['totals']['completed_roots']}, rounds {run['totals']['rounds']}, "
            f"no overflow, exact launches per round; "
            f"{run['transitions_per_sec']:.1f} transitions/s over the "
            f"{run['waves'] - 1} waves after the first ({run['timed_seconds']:.3f} s); "
            f"launches {run['launches']}; table-commit device launches "
            f"{run['commit_launches']['device']} for {run['commit_launches']['calls']} "
            f"commits ({run['commit_launches']['device'] / run['totals']['rounds']:.0f} "
            f"a round); device launches {run['commit_launches']['all']}; "
            f"ticks {run['totals'].get('ticks', 0)}; peak memory "
            f"{run['peak_bytes'] / 2**20:.1f} MiB")
    # phase 11 (here, beside the drives): the captured step against the eager one
    capture_phase(report)
    # phases 6 to 10 step only through the served engine and the mesh, which
    # call kernel.step_kernel: none of their steps is captured or replayed
    from zeebe_tpu_torch.tpu import capture

    capture.release()

    # phase 6: the serving path. The first engine built in this process
    # runs the boot self-check inside its constructor
    import shutil
    import tempfile

    from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

    workdir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="serve-", dir=workdir)
    try:
        if ops._SELFCHECKED:
            raise AssertionError("the boot self-check ran before the first engine")
        reset_launches()
        t0 = time.perf_counter()
        CudaPartitionEngine(0, 1, capacity=SERVE_CAPACITY)
        boot_s = time.perf_counter() - t0
        by_path["selfcheck"] = launch_counts()
        boot_commits = commit_device_launches("selfcheck")
        zero = [k for k in SELFCHECK_KERNELS if by_path["selfcheck"][k] <= 0]
        if torch.cuda.current_device() not in ops._SELFCHECKED or zero:
            raise AssertionError(f"the boot self-check did not run its kernels: {zero}")
        report["selfcheck"] = {"seconds": boot_s, "launches": by_path["selfcheck"]}
        log(f"[6] first engine on the card: boot self-check bit-equal in "
            f"{boot_s:.3f} s; launches {by_path['selfcheck']}; device launches "
            f"{boot_commits['all']}")
        served = {}
        for label, model_fn, instances, per_instance, payload, advance_ms, after_create in (
            ("config1", config1_model, SERVE_INSTANCES, TRANSITIONS_PER_INSTANCE,
             order_payload, 0, None),
            ("config3", config3_model, SERVE_INSTANCES_C3, TRANSITIONS_PER_INSTANCE_C3,
             order_payload, 0, None),
            ("config2", config2_model, SERVE_INSTANCES_C2, TRANSITIONS_PER_INSTANCE_C2,
             alternating_payload, 0, None),
            ("timers", timer_model, SERVE_INSTANCES_TIMER, SIGNATURE_PER_TIMER_INSTANCE,
             order_payload, 2 * TIMER_MS, None),
            ("config4", config4_model, SERVE_INSTANCES_C4, C4_PER_DRIVE, c4_payload,
             C4_TICK_MS, c4_publisher(2)),
            ("config5", config5_model, SERVE_INSTANCES_C5, TRANSITIONS_PER_INSTANCE_C5,
             order_payload, 0, None),
        ):
            run = serve_checked(label, model_fn, instances, per_instance, workdir,
                                payload=payload, advance_ms=advance_ms,
                                after_create=after_create)
            served[label] = (model_fn, payload, advance_ms, after_create,
                             run.pop("signature"))
            report["serving_" + label] = run
            by_path["serving_" + label] = run["launches"]
            log(f"[6a] {label} served through the Broker: {instances} instances, "
                f"capacity {SERVE_CAPACITY}, {SERVE_CREDITS} credits: "
                f"{run['records']} records ({run['signature_records']} signature, "
                f"{run['device_records']} through the step kernel, "
                f"{run['host_records']} host-side) in {run['wall_seconds']:.3f} s "
                f"= {run['records_per_sec']:.1f} records/s, {run['ticks']} ticks; "
                f"launches {run['launches']}; table-commit device launches "
                f"{run['commit_launches']['device']} for "
                f"{run['commit_launches']['calls']} commits; device launches "
                f"{run['commit_launches']['all']}; job records in flight at rest "
                f"{run['in_flight_at_rest']}")
        par = serve_parity(workdir)
        report["serving_parity"] = par
        log(f"[6b] config 1, {par['instances']} instances, {SERVE_CREDITS} credits "
            f"(a credit drought): cuda == cpu, equal log signatures "
            f"({par['signature_records']} records; cuda {par['cuda_seconds']:.3f} s, "
            f"cpu {par['cpu_seconds']:.3f} s)")
        for label, jobs in (("config2", 1), ("timers", 1), ("config4", 1),
                            ("config5", C5_CARDINALITY)):
            model_fn, payload, advance_ms, after_create, sig = served[label]
            par = serve_parity_with_oracle(
                label, model_fn, sig, report["serving_" + label]["instances"],
                workdir, payload=payload, advance_ms=advance_ms,
                after_create=after_create, jobs_per_instance=jobs)
            report["serving_parity_" + label] = par
            log(f"[6b] {label}, {par['instances']} instances: the card's log "
                f"signature ({par['signature_records']} records) equal on cpu "
                f"({par['cpu_seconds']:.3f} s); with {par['credits']} credits the "
                f"card's ({par['cuda_full_credit_seconds']:.3f} s) equal to the "
                f"port's host oracle's ({par['oracle_full_credit_seconds']:.3f} s, "
                f"{par['full_credit_signature_records']} records)")
        if args.profile:
            report["profile_selfcheck"] = profile_selfcheck()
            for row in report["profile_selfcheck"]:
                log(f"[p] self-check: {row['count']}x {row['name']} "
                    f"{row['device_us']:.2f} us each")
            prof = profile_serving(workdir, SERVE_INSTANCES_C3)
            report["profile_serving"] = prof
            log(f"[p] config 1 served, {prof['instances']} instances: "
                f"{prof['records']} records, wall {prof['wall_ms']:.1f} ms, device "
                f"busy {prof['device_busy_ms']:.1f} ms (idle share "
                f"{prof['device_idle_share']:.3f}), {prof['device_launches']} device ops")
            for row in prof["top"]:
                log(f"    {row['device_ms']:9.3f} ms {row['count']:6d}x {row['name']}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # phase 7: the primitive-cost probe (python -m zeebe_tpu_torch.probe)
    from zeebe_tpu_torch import probe

    reset_launches()
    report["probe"] = probe.main()
    by_path["probe"] = launch_counts()
    zero = [k for k in PROBE_KERNELS if by_path["probe"][k] <= 0]
    if zero:
        raise AssertionError(f"the probe never launched {zero}")
    log(f"[7] probe benchmark: {report['probe']}; launches {by_path['probe']}")

    # phase 8: the cluster serving path, each run's launches counted from 0
    workdir = tempfile.mkdtemp(prefix="cluster-", dir=os.path.join(here, "build",
                                                                   "chip_smoke"))
    try:
        runs = {}
        for engine_type in ("cuda", "host"):
            reset_launches()
            runs[engine_type] = cluster_serve(engine_type, workdir)
            if engine_type == "cuda":
                by_path["cluster_serving"] = launch_counts()
        run, oracle = runs["cuda"], runs["host"]
        zero = [k for k in CLUSTER_KERNELS if by_path["cluster_serving"][k] <= 0]
        if zero:
            raise AssertionError(f"8a: kernels never launched serving: {zero}")
        if run["kinds"] != oracle["kinds"]:
            diff = {k: (run["kinds"].get(k), oracle["kinds"].get(k))
                    for k in set(run["kinds"]) | set(oracle["kinds"])
                    if run["kinds"].get(k) != oracle["kinds"].get(k)}
            raise AssertionError(f"8a: the card's and the oracle's logs hold other "
                                 f"records (card, oracle): {diff}")
        for r in (run, oracle):
            r["kinds"] = {"/".join(map(str, k)): n for k, n in sorted(r["kinds"].items())}
        report["cluster_serving"], report["cluster_serving_oracle"] = run, oracle
        log(f"[8a] {run['instances']} instances from {run['pumps']} pumps through "
            f"ClusterClient -> TCP -> ClusterBroker (raft, WaveScheduler) -> "
            f"CudaPartitionEngine on the card, {run['credits']} credits: every instance "
            f"completed once in {run['elapsed_seconds']:.3f} s; {run['records']} records "
            f"= {run['records_per_sec']:.1f} records/s, {run['instances_per_sec']:.1f} "
            f"instances/s; latency p50 {run['p50_latency_ms']:.1f} ms, p99 "
            f"{run['p99_latency_ms']:.1f} ms; {run['waves']:.0f} waves; host "
            f"{run['host_seconds']:.3f} s, device {run['device_seconds']:.3f} s; "
            f"job records in flight at rest {run['in_flight_at_rest']}; "
            f"launches {by_path['cluster_serving']}")
        log(f"[8a] the same on the host oracle: {oracle['records']} records in "
            f"{oracle['elapsed_seconds']:.3f} s = {oracle['records_per_sec']:.1f} "
            f"records/s, {oracle['instances_per_sec']:.1f} instances/s; p50 "
            f"{oracle['p50_latency_ms']:.1f} ms, p99 {oracle['p99_latency_ms']:.1f} ms; "
            f"the two logs hold the same counts of every (record type, value type, "
            f"intent)")
        reset_launches()
        t0 = time.perf_counter()
        fo = cluster_failover(workdir)
        by_path["cluster_failover"] = launch_counts()
        zero = [k for k in CLUSTER_KERNELS if by_path["cluster_failover"][k] <= 0]
        if zero:
            raise AssertionError(f"8b: kernels never launched: {zero}")
        fo["seconds"] = time.perf_counter() - t0
        report["cluster_failover"] = fo
        log(f"[8b] 3 brokers, 2 partitions on one card: {fo['instances_per_partition']} "
            f"instances a partition in {fo['serve_seconds']:.3f} s; every replica holds "
            f"the device snapshot; partition 0's leader closed, a new leader restored "
            f"from it and replayed in {fo['failover_seconds']:.3f} s, served "
            f"{fo['instances_per_partition']} more in {fo['after_failover_seconds']:.3f} "
            f"s; every instance completed once, replicas equal over positions (first, common) "
            f"{fo['common_positions']}, leaders' raft terms {fo['leader_terms']}, "
            f"collector pauses over 100 ms {fo['gc_pauses'][0]} (longest "
            f"{fo['gc_pauses'][1]:.3f} s), job records in flight at rest "
            f"{fo['in_flight_at_rest']} ({fo['seconds']:.1f} s); launches "
            f"{by_path['cluster_failover']}")
        ep = entry_point(workdir)
        report["entry_point"] = ep
        log(f"[8c] python -m zeebe_tpu_torch (ZEEBE_ENGINE_TYPE=cuda): "
            f"'{ep['start_line']}'; served {ep['instances']} instances in "
            f"{ep['serve_seconds']:.3f} s after {ep['ready_seconds']:.3f} s to ready; "
            f"/metrics: {ep['waves']:.0f} waves, device {ep['device_seconds']:.3f} s; "
            f"{ep['gateway']}; exit {ep['exit_code']} on SIGTERM")
        reset_launches()
        t0 = time.perf_counter()
        st = stranded_job(workdir)
        by_path["cluster_stranded"] = launch_counts()
        zero = [k for k in CLUSTER_KERNELS if by_path["cluster_stranded"][k] <= 0]
        if zero:
            raise AssertionError(f"8d: kernels never launched: {zero}")
        st["seconds"] = time.perf_counter() - t0
        report["cluster_stranded"] = st
        log(f"[8d] a worker with one credit, a second job stranded, the first job's "
            f"{st['timeout_ms']} ms deadline passed, the credit returned: "
            f"{st['backlog_activations']} backlog activation through PROBE_JOB_BACKLOG "
            f"({st['probes_with_backlog_bit']} of {st['probes']} probes with the bit, "
            f"{st['scans']} scans), pushed {st['push_seconds']:.3f} s after the credit; "
            f"ACTIVATE commands {st['activations']}, none rejected; job records in "
            f"flight at rest {st['in_flight_at_rest']} ({st['seconds']:.1f} s); launches "
            f"{by_path['cluster_stranded']}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # phase 9: the mesh, each path's launches counted from 0
    mesh_phase(here, report, by_path, args.profile)

    # phase 10: the production planes, each path's launches counted from 0
    planes_phase(here, report, by_path)
    counts = capture.counts()
    if counts["captures"] or counts["replays"]:
        raise AssertionError(f"phases 6-10 stepped through the drive's capture: {counts}")
    log("[11] phases 6-10 (served engine, cluster, mesh, planes) stepped eagerly through "
        "kernel.step_kernel: no drive step captured or replayed")

    if args.profile:
        report["profile_eval_programs"] = profile_eval_programs(WAVE)
        ev = report["profile_eval_programs"]
        log(f"[p] eval_programs, one call at B={WAVE}: {ev['ms']:.4f} ms, device "
            f"{ev['device_ms']:.4f} ms in {ev['device_launches']} device ops")
        for label, name, setup, one_wave, wave in (
            ("profile", "config 1", config_setup, creates_wave, WAVE),
            ("profile_config3", "config 3",
             functools.partial(config_setup, model_fn=config3_model), creates_wave, WAVE),
            ("profile_config2", "config 2",
             functools.partial(config_setup, model_fn=config2_model), creates_wave, WAVE),
            ("profile_config4", "config 4", c4_setup, c4_wave, WAVE),
            ("profile_config5", "config 5",
             functools.partial(config_setup, model_fn=config5_model,
                               cap_factor=CAP_FACTOR_C5), creates_wave, WAVE_C5),
        ):
            prof = profile_config(wave, setup, one_wave)
            report[label] = prof
            log(f"[p] {name}, one wave of {wave}: {prof['rounds']} "
                f"rounds, wall {prof['wall_ms']:.1f} ms, device busy "
                f"{prof['device_busy_ms']:.1f} ms (idle share "
                f"{prof['device_idle_share']:.3f}), {prof['device_launches']} device ops, "
                f"peak memory {prof['peak_bytes'] / 2**20:.1f} MiB")
            for row in prof["top"]:
                log(f"    {row['device_ms']:9.3f} ms {row['count']:6d}x {row['name']}")
            reb = prof["rebuild"]
            log(f"[p] {name}, the lookup-state rebuild after it: wall "
                f"{reb['wall_ms']:.3f} ms, device busy {reb['device_busy_ms']:.3f} ms; ours "
                + "; ".join(f"{r['count']}x {r['name']} {r['device_ms']:.4f} ms"
                            for r in reb["ours"]))
        scan = profile_disarm_scan(WAVE)
        report["profile_disarm_scan"] = scan
        log(f"[p] config 4's disarm timer scan, {scan['keys']} keys over {scan['timers']} "
            f"timers, twice: {scan['scan_ms']:.4f} ms (peak +"
            f"{scan['scan_peak_extra_bytes'] / 2**20:.1f} MiB); the dense [B, T] form "
            f"{scan['dense_ms']:.4f} ms (peak +{scan['dense_peak_extra_bytes'] / 2**20:.1f} MiB)")
    # launches: the sum over the main-path runs (phases 4 to 5d, 6: the boot
    # self-check and the six served runs, 7: the probe, 8a, 8b and 8d: the
    # cluster runs in this process (8c's node is another process), 9a's six
    # runs and 9b's cuda run, 10a's in-process pairs and three card runs, 10b's
    # card run and 10c's two runs), each
    # run's own count beside it; masked_row_add and masked_row_max, which
    # no path calls (config 3's maxima are one fused_accumulate), stay at 0
    for row in kernels:
        row["launches_by_path"] = {p: c[row["name"]] for p, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    report["kernels"] = kernels
    report["card"] = smi
    report["seconds"] = time.perf_counter() - t_script
    log(f"[end] every phase passed in {report['seconds']:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)

    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_us", "host_us")
    print(smi, flush=True)
    print(json.dumps({"kernels": [{k: row.get(k) for k in keys} for row in kernels]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Exception:  # any phase failure: report it and exit non-zero
        traceback.print_exc()
        # no interpreter teardown: threads of a phase that failed may still
        # be inside a library call, and tearing it down under them aborts
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
