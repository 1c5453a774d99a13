#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA engine (``zeebe_tpu_torch``).

Builds the hand-written CUDA kernels from ``zeebe_tpu_torch/csrc`` (phase
1), holds each of the 13 kernel wrappers against its plain PyTorch
version on the card at the main paths' shapes and times it: around one
wrapper call (host work inside), and for the gather and the table
commits also on the host alone and on the device alone, back to back
(phase 2). It checks the drive loop on the card bit-equal to the same
loop on the CPU on configs 1, 3 and 2 and an I/O-mapping graph, and one
mixed and one timer step (phase 3), then drives, at the benchmark's
accelerator width and through the package's own entry points, config 1
(the order-process: start → service task "payment-service" → end; phase
4), config 3 (parallel fork/join; phase 5) and config 2 (an exclusive
gateway with a json-el condition; phase 5b), all with synthetic instant
workers, and shows from the launch counters that each run went through
every kernel of its path, exactly as often as its rounds and rebuilds
ask, and that no table commit enqueued more than 3 device launches (5 a
drive round). Phase 6 serves through the port's in-process ``Broker``
with ``CudaPartitionEngine`` — client → log → engine → job pushed to a
worker → completion → log: the first engine's construction runs the boot
self-check (insert, lookup, delete, row update, lane update and lane
accumulate against their plain versions, bit for bit); 6a serves configs
1, 3 and 2 and a timer-catch workflow (the clock moved past the timers)
and checks every instance completed device-served with every kernel of
the path launched; 6b checks credit-drought logs on the card equal to
the same runs' on the CPU, and config 2's and the timers' equal to the
port's host oracle at full credit. Phase 7 runs the primitive-cost probe
(``zeebe_tpu_torch.probe``: the row loop and the hash probe against
``index_put_``).

    python3 chip_smoke.py                     # the full check, one CUDA card
    python3 chip_smoke.py --profile --out F   # + one wave of each config and one
                                              #   eval_programs call under
                                              #   torch.profiler, every number
                                              #   written to F (JSON)

Every phase passes or the script exits non-zero. The last line of standard
output is ``{"ok": true, "device": {...}}``; before it come the card's name
and power limit as nvidia-smi reports them and a ``{"kernels": [...]}``
line. Without a CUDA device, or without the package beside it, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
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
# the device functions of zeebe_tpu_torch/csrc, as the profiler names them
OUR_KERNELS = ("gather_rows_kernel", "commit_pass_kernel", "hash_lookup_kernel",
               "hash_insert_kernel", "hash_delete_kernel")
# a spin of this many clock cycles (about 11 ms at 1.98 GHz) holds the
# stream while the host enqueues the launches device_us times
SPIN_CYCLES = 20_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


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


def config_setup(wave, device, model_fn=config1_model, mixed=False):
    """Graph, meta, state, queue and a CREATE wave for config 1 (or, with
    ``model_fn`` another config's model, that config: the same settings)."""
    from zeebe_tpu_torch.tpu import drive

    graph, meta = config_graph(device, model_fn)
    num_vars = graph.num_vars
    state = config_state(meta, CAP_FACTOR * wave, num_vars, device)
    queue = drive.make_queue(4 * wave * max(2, graph.emit_width), num_vars,
                             device=device)
    return graph, state, queue, config_creates(meta, wave, num_vars, device, mixed)


def drive_config(waves, wave, device, timed_from=1, model_fn=config1_model,
                 rebuild_every=REBUILD_EVERY, mixed=False):
    """Config 1 (or another) through the package's entry points: compile the
    graph, make the state and queue, then per wave enqueue CREATEs and
    drive to quiescence with synthetic workers; rebuild the lookup state
    after the first wave and every ``rebuild_every`` waves after it.
    Returns (state, totals over all waves, seconds of the waves from
    ``timed_from`` on)."""
    import torch

    from zeebe_tpu_torch.tpu import drive, state as state_mod

    graph, state, queue, creates = config_setup(wave, device, model_fn, mixed)
    totals = {"processed": 0, "emitted": 0, "completed_roots": 0, "rounds": 0}
    t0 = None
    for i in range(waves):
        if i == timed_from:
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
        queue = drive.enqueue(queue, creates)
        state, queue, t = drive.run_to_quiescence(
            graph, state, queue, 0, wave, synthetic_workers=True,
        )
        for k in totals:
            totals[k] += t[k]
        if i % rebuild_every == 0:
            state = state_mod.rebuild_lookup_state(state)
    if device != "cpu":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0 if t0 is not None else 0.0
    return state, totals, elapsed


def profile_config(wave, warm_waves=2, model_fn=config1_model):
    """One config-1 (or 3) wave at full width under torch.profiler, after
    ``warm_waves`` unprofiled ones: wall time, summed device kernel time,
    the device's idle share and the kernels that take the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zeebe_tpu_torch.tpu import drive, state as state_mod

    graph, state, queue, creates = config_setup(wave, "cuda", model_fn)
    for _ in range(warm_waves):
        queue = drive.enqueue(queue, creates)
        state, queue, _t = drive.run_to_quiescence(graph, state, queue, 0, wave,
                                                   synthetic_workers=True)
        state = state_mod.rebuild_lookup_state(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        queue = drive.enqueue(queue, creates)
        state, queue, totals = drive.run_to_quiescence(graph, state, queue, 0, wave,
                                                       synthetic_workers=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side events only: an operator's device time is also its kernels'
    events, dev_us = _device_events(prof)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:15]
    top += [e for e in events
            if e not in top and any(k in e.key for k in OUR_KERNELS)]
    return {
        "wave": wave, "rounds": totals["rounds"], "wall_ms": wall * 1e3,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
        "device_launches": sum(e.count for e in events),
        "top": [{"name": e.key[:90], "device_ms": dev_us(e) / 1e3, "count": e.count}
                for e in top],
    }


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
    fn, stream = ops._gather_fn(), ops._stream()
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
    fn, stream = ops._commit_fn(), ops._stream()
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


def check_lookup(dev, gen):
    """The element-instance map (T = 2^19 buckets for N = 2^16) probed with
    3B = 3·2^14 keys: hits, misses, tombstones, invalid keys."""
    import torch

    from zeebe_tpu_torch.tpu import hashmap, ops

    n = CAP_FACTOR * WAVE
    b = WAVE
    t = 1
    while t < 8 * n:
        t *= 2
    keys = torch.arange(n, dtype=torch.int64, device=dev) * 5 + 1
    table, ok = hashmap.insert(
        hashmap.make(t, device=dev), keys, torch.arange(n, dtype=torch.int32, device=dev),
        torch.ones(n, dtype=torch.bool, device=dev),
    )
    assert bool(ok.all())
    dead = (torch.rand((n,), generator=gen) < 0.2).to(dev)
    table = hashmap.delete(table, keys, dead)
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
    nv = int(valid.sum())
    nbytes = 3 * b * (8 + 1 + 1 + 4) + nv * 12  # ≥ one bucket per valid key
    return {
        "name": "lookup", "route": "cuda",
        "source": "zeebe_tpu_torch/csrc/hash_lookup.cu",
        "replaces": "zeebe_tpu/tpu/pallas_ops.py:972",
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.lookup(table, q, valid)),
        "plain_ms": time_ms(lambda: ops.lookup_reference(table, q, valid)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,  # no PyTorch call probes an open-addressing map
        "shape": f"{3 * b} keys ({nv} valid), T={t}",
    }


# the masked scatters (one-op commits of csrc/table_commit.cu): per wrapper,
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
    shapes (plus the two wrappers no path launches); one row per wrapper."""
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
        # the C entry on the wrapper's own descriptor (vec64: lo/hi planes)
        if dtype == torch.int64:
            d, _keep = ops._scatter_desc(name, work.view(torch.int32).view(-1, 2), kind,
                                         slots, active, vals.view(torch.int32).view(-1, 2),
                                         None)
        else:
            d, _keep = ops._scatter_desc(name, work, kind, slots, active, vals, mask)
        entry, stream = ops._commit_fn(), ops._stream()
        out.append({
            "name": name, "route": "cuda",
            "source": "zeebe_tpu_torch/csrc/table_commit.cu",
            "replaces": f"zeebe_tpu/tpu/pallas_ops.py{line}",
            "max_abs_err": err,
            "ms": time_ms(lambda: fn(work, slots, active, vals, *extra)),
            "plain_ms": time_ms(lambda: ops.masked_scatter_reference(
                plain, kind, slots, active, vals, mask)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": library_ms,
            "device_us": device_us(lambda: entry(ctypes.byref(d), 1, stream)),
            "host_us": host_us(lambda: fn(work, slots, active, vals, *extra)),
            "device_launches": entry(ctypes.byref(d), 1, stream),
            **library,
            "shape": "; ".join(
                f"[{', '.join(map(str, c[0]))}] {c[1]}{' lane-masked' if c[2] else ''}"
                f", B={c[3] if len(c) > 3 else WAVE}" for c in cases),
        })
    return out


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


def check_insert(dev, gen):
    """The join map (2^18 buckets) preloaded to ~40% live with tombstones
    mixed in, taking B = 2^14 new keys; and the rebuild shape, 2^16 keys
    into a fresh 2^18-bucket map. Bit-equal buckets, values and ``ok``."""
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
    placed = []
    for tbl, k, v, ok_in in ((base, keys, vals, valid), (fresh, rkeys, rvals, rlive)):
        (got,) = _copies(tbl, 1)
        got, got_ok = ops.insert(got, k, v, ok_in)
        want, want_ok = hashmap.insert(tbl, k, v, ok_in)
        torch.cuda.synchronize()
        err = max(err, max_abs_err([got.keys, got.vals, got_ok.to(torch.int32)],
                                   [want.keys, want.vals, want_ok.to(torch.int32)]))
        placed.append(int(want_ok.sum()))
    if err != 0.0:
        raise AssertionError(f"insert differs from its plain version: {err}")
    reps = 28  # time_ms's warmup + reps: one fresh table per call
    nv = int(valid.sum())
    # flags in and ok out per key; per valid key its key, value and at least
    # one bucket read; per placed key one bucket (key, value) written
    nbytes = b * 2 + nv * (8 + 4 + 8) + placed[0] * 12
    tables = iter(_copies(base, reps))
    fresh_tables = iter(_copies(fresh, reps))
    return {
        "name": "insert", "route": "cuda",
        "source": "zeebe_tpu_torch/csrc/hash_update.cu",
        "replaces": "zeebe_tpu/tpu/pallas_ops.py:1043",
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.insert(next(tables), keys, vals, valid)),
        "plain_ms": time_ms(lambda: hashmap.insert(base, keys, vals, valid)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,  # no PyTorch call inserts into an open-addressing map
        "rebuild_ms": time_ms(lambda: ops.insert(next(fresh_tables), rkeys, rvals, rlive)),
        "rebuild_plain_ms": time_ms(lambda: hashmap.insert(fresh, rkeys, rvals, rlive)),
        "shape": f"{b} keys ({nv} valid) into T={t} with {live} live, {tomb} "
                 f"tombstones; rebuild: {n} keys ({int(rlive.sum())} live) into a fresh T={t}",
    }


def check_delete(dev, gen):
    """B = 2^14 keys, half of them present, out of the ~40%-live join map."""
    import torch

    from zeebe_tpu_torch.tpu import hashmap, ops

    b = WAVE
    base, pre, absent = _join_map(dev, gen, b)
    t = base.keys.shape[0]
    pick = torch.randperm(pre.shape[0], generator=gen)[: b // 2].to(dev)
    keys = torch.cat([pre[pick], absent[: b - b // 2]])
    valid = (torch.rand((b,), generator=gen) < 0.9).to(dev)
    (got,) = _copies(base, 1)
    got = ops.delete(got, keys, valid)
    want = hashmap.delete(base, keys, valid)
    torch.cuda.synchronize()
    err = max_abs_err([got.keys, got.vals], [want.keys, want.vals])
    if err != 0.0:
        raise AssertionError(f"delete differs from its plain version: {err}")
    nv = int(valid.sum())
    deleted = int((got.keys != base.keys).sum())
    # flags in; per valid key its key and at least one bucket read; per
    # deleted key one tombstone written
    nbytes = b + nv * (8 + 8) + deleted * 8
    tables = iter(_copies(base, 28))
    return {
        "name": "delete", "route": "cuda",
        "source": "zeebe_tpu_torch/csrc/hash_update.cu",
        "replaces": "zeebe_tpu/tpu/pallas_ops.py:1130",
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.delete(next(tables), keys, valid)),
        "plain_ms": time_ms(lambda: hashmap.delete(base, keys, valid)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,  # no PyTorch call deletes from an open-addressing map
        "shape": f"{b} keys ({nv} valid, {deleted} deleted) out of T={t}",
    }


def check_row_loop(dev, gen):
    """The probe's row loop at its own sizes (B = 2^14 random indices into
    CAP = 2^16 rows of K = 128 int32: about 1,700 rows named more than
    once), n_writes 1 and 10, from a random table: bit-equal in place."""
    import torch

    from zeebe_tpu_torch import probe

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
        "shape": f"B={b} keys into T={tkeys.shape[0]} i32; hits {hits}",
    }


# ---------------------------------------------------------------------------
# phase 3: the whole path on the card against the same path on the CPU
# ---------------------------------------------------------------------------


# the wrappers each main path must launch (the lookup-state rebuild
# inserts through the insert kernel on both paths)
CONFIG1_KERNELS = ("fused_gather_rows", "fused_table_commit", "lookup", "insert")
CONFIG3_KERNELS = CONFIG1_KERNELS + (
    "masked_row_update", "masked_row_max", "masked_lane_update",
    "masked_vec64_update", "delete",
)
TIMER_KERNELS = CONFIG1_KERNELS + ("delete",)
PROBE_KERNELS = ("row_loop", "probe")
# exact launches of a drive: per round of the step, and per lookup-state
# rebuild (one insert for each of the six maps); config 2 runs config 1's
# kernels (the condition programs are plain PyTorch)
PER_ROUND = {
    "config1": {"fused_gather_rows": 8, "fused_table_commit": 2, "lookup": 2},
    "config3": {"fused_gather_rows": 8, "fused_table_commit": 2, "lookup": 4,
                "masked_row_update": 3, "masked_row_max": 2, "masked_lane_update": 2,
                "masked_vec64_update": 2, "insert": 1, "delete": 1},
}
PER_ROUND["config2"] = PER_ROUND["config1"]
INSERTS_PER_REBUILD = 6
# device launches of the table commits: a round's element-instance commit
# is 3 (the token add's pass, the sets' claim and write passes), its job
# commit 2; no commit of any path takes more than 3
COMMIT_DEVICE_PER_ROUND = 5
COMMIT_DEVICE_MAX = 3


def reset_launches() -> None:
    from zeebe_tpu_torch import probe
    from zeebe_tpu_torch.tpu import ops

    ops.reset_launches()
    probe.reset_launches()


def launch_counts() -> dict:
    """Every wrapper's launches since the last reset: the 11 of ``ops``
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


def drive_path(label, model_fn, instances, per_instance, path):
    """One config at the benchmark's width on the card, the launch counters
    zeroed just before and read just after: every instance completed,
    ``per_instance`` records processed per instance, no overflow (the drive
    loop raises on one), every kernel of ``path`` launched, and each
    wrapper launched exactly as often as the rounds and rebuilds ask."""
    import torch

    waves = instances // WAVE
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    _state, totals, elapsed = drive_config(waves, WAVE, "cuda", model_fn=model_fn)
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
    want["insert"] += INSERTS_PER_REBUILD * rebuilds
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} != {want} "
                             f"({totals['rounds']} rounds, {rebuilds} rebuilds)")
    commits = commit_device_launches(label)
    if commits["device"] != COMMIT_DEVICE_PER_ROUND * totals["rounds"]:
        raise AssertionError(f"{label}: {commits['device']} commit launches in "
                             f"{totals['rounds']} rounds")
    timed = (waves - 1) * WAVE * per_instance
    return {
        "waves": waves, "wave": WAVE, "instances": instances,
        "totals": totals, "timed_seconds": elapsed, "timed_transitions": timed,
        "transitions_per_sec": timed / elapsed if elapsed > 0 else float("nan"),
        "launches": launches, "commit_launches": commits,
        "peak_bytes": torch.cuda.max_memory_allocated(),
    }


def parity(wave=1024, waves=3, model_fn=config1_model,
           per_instance=TRANSITIONS_PER_INSTANCE, rebuild_every=REBUILD_EVERY,
           mixed=False, per_stopped=0):
    """Drive a config on the card and on the CPU: bit-equal state and
    totals, ``per_instance`` records per instance (``per_stopped`` for the
    instances ``mixed`` leaves without orderValue)."""
    import numpy as np

    from zeebe_tpu_torch.tpu import state as state_mod

    results = {}
    for device in ("cuda", "cpu"):
        st, totals, _ = drive_config(waves, wave, device, model_fn=model_fn,
                                     rebuild_every=rebuild_every, mixed=mixed)
        results[device] = (state_mod.state_to_numpy(st), totals)
    (a, ta), (c, tc) = results["cuda"], results["cpu"]
    if ta != tc:
        raise AssertionError(f"totals differ: cuda {ta} cpu {tc}")
    bad = [k for k in a if a[k].dtype != c[k].dtype or a[k].shape != c[k].shape
           or not np.array_equal(a[k], c[k])]
    if bad:
        raise AssertionError(f"state differs between cuda and cpu: {bad}")
    stopped = int(mixed_order_values(wave)[1].sum()) if mixed else 0
    want = waves * (per_instance * (wave - stopped) + per_stopped * stopped)
    if ta["processed"] != want or ta["completed_roots"] != waves * (wave - stopped):
        raise AssertionError(f"totals {ta}: processed != {want} or completed != "
                             f"{waves * (wave - stopped)}")
    return ta


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
# config 2 and the timer workflow at the same quarter
SERVE_INSTANCES_C2 = SERVE_INSTANCES // 4
SERVE_INSTANCES_TIMER = SERVE_INSTANCES // 4
# signature records per served timer instance
SIGNATURE_PER_TIMER_INSTANCE = 29
# the wrappers a served wave of each config must launch; the boot
# self-check's own
SERVING_KERNELS = {"config1": CONFIG1_KERNELS, "config2": CONFIG1_KERNELS,
                   "config3": CONFIG3_KERNELS, "timers": TIMER_KERNELS}
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


def alternating_payload(i):
    """orderValue 99 and 10 in turns: config 2's two branches."""
    return {"orderId": i, "orderValue": (99, 10)[i % 2]}


def serve(model_fn, instances, device, workdir, credits=SERVE_CREDITS,
          capacity=SERVE_CAPACITY, payload=order_payload, advance_ms=0):
    """Serve ``instances`` instances of one config through the port's
    in-process Broker on ``device`` ("cuda", "cpu", or "oracle": the port's
    copy of the host oracle engine instead of CudaPartitionEngine): deploy
    through the client, one job worker, a burst of CREATE commands written
    to the log at once, one drain, the clock moved on by ``advance_ms``,
    then ticks (each drains) until a tick adds no record. Closes the broker
    and returns its engine, its log, the wall seconds from the first CREATE
    to the last record, and the number of ticks."""
    import tempfile

    import torch

    from zeebe_tpu_torch.engine.interpreter import WorkflowRepository
    from zeebe_tpu_torch.gateway import JobWorker, ZeebeClient
    from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI
    from zeebe_tpu_torch.protocol.records import WorkflowInstanceRecord
    from zeebe_tpu_torch.runtime import Broker, ControlledClock
    from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

    clock = ControlledClock(start_ms=1_000_000)
    repo = WorkflowRepository()
    broker = Broker(
        num_partitions=1, clock=clock,
        data_dir=tempfile.mkdtemp(prefix="serve-", dir=workdir),
        engine_factory=None if device == "oracle" else (
            lambda pid: CudaPartitionEngine(
                pid, 1, repository=repo, clock=clock, capacity=capacity,
                num_vars=16, sub_capacity=16, device=device,
            )
        ),
    )
    engine = broker.partitions[0].engine
    model = model_fn()
    ZeebeClient(broker).deploy_model(model)
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
    clock.advance(advance_ms)
    ticks = 0
    while True:
        before = log_.next_position
        broker.tick()
        broker.run_until_idle()
        ticks += 1
        if log_.next_position == before:
            break
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    records = broker.records(0)
    broker.close()
    return engine, records, wall, ticks


def serve_checked(label, model_fn, instances, per_instance, workdir,
                  payload=order_payload, advance_ms=0):
    """Phase 6a for one config on the card, the launch counters zeroed
    just before and read just after."""
    import torch

    from zeebe_tpu_torch.protocol.enums import ValueType
    from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    engine, records, wall, ticks = serve(model_fn, instances, "cuda", workdir,
                                         payload=payload, advance_ms=advance_ms)
    launches = launch_counts()
    commits = commit_device_launches(label)
    sig = record_signature(records)
    completed = sum(
        1 for r in records
        if int(r.metadata.value_type) == int(ValueType.WORKFLOW_INSTANCE)
        and int(r.metadata.intent) == int(WI.ELEMENT_COMPLETED)
        and r.key == getattr(r.value, "workflow_instance_key", None)
    )
    if completed != instances:
        raise AssertionError(f"{label}: {completed} of {instances} processes completed")
    if len(sig) != per_instance * instances:
        raise AssertionError(
            f"{label}: {len(sig)} signature records != {per_instance} x {instances}")
    if engine.host_only_reasons:
        raise AssertionError(f"{label}: workflows served host-side: "
                             f"{engine.host_only_reasons}")
    if engine._host.element_instances.instances:
        raise AssertionError(f"{label}: instances left in the embedded oracle")
    if engine.host_records_processed > len(records) - len(sig):
        raise AssertionError(f"{label}: instance records processed host-side")
    zero = [k for k in SERVING_KERNELS[label] if launches[k] <= 0]
    if zero:
        raise AssertionError(f"{label}: kernels never launched serving: {zero}")
    return {
        "instances": instances, "credits": SERVE_CREDITS, "capacity": SERVE_CAPACITY,
        "records": len(records), "signature_records": len(sig),
        "device_records": engine.device_records_processed,
        "host_records": engine.host_records_processed, "ticks": ticks,
        "wall_seconds": wall, "records_per_sec": len(records) / wall,
        "launches": launches, "commit_launches": commits,
        "peak_bytes": torch.cuda.max_memory_allocated(), "signature": sig,
    }


def _same_log(label, a, b, what):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            raise AssertionError(f"{label}: {what} differ at signature record {i}: "
                                 f"{x} vs {y}")
    if len(a) != len(b):
        raise AssertionError(f"{label}: {what} differ in length: {len(a)} vs {len(b)}")


def serve_parity_with_oracle(label, model_fn, cuda_sig, instances, workdir,
                             payload=order_payload, advance_ms=0):
    """Phase 6b for a served run of 6a: the same scenario on the CPU writes
    the card's log signature; and with credits for every instance, the card
    and the port's host oracle write the same log. (In a credit drought the
    JAX engine, which the port follows, and the oracle re-assign stranded
    jobs in another order: ROADMAP's note on the reference.)"""
    out = {"instances": instances, "signature_records": len(cuda_sig)}
    _engine, records, out["cpu_seconds"], _ticks = serve(
        model_fn, instances, "cpu", workdir, payload=payload, advance_ms=advance_ms)
    _same_log(label, cuda_sig, record_signature(records), "cuda and cpu logs")
    sigs = {}
    for device in ("cuda", "oracle"):
        _engine, records, out[device + "_full_credit_seconds"], _ticks = serve(
            model_fn, instances, device, workdir, credits=instances, payload=payload,
            advance_ms=advance_ms)
        sigs[device] = record_signature(records)
    _same_log(label, sigs["cuda"], sigs["oracle"],
              f"cuda and oracle logs at {instances} credits")
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


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every measured number here (JSON)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one full-width wave (torch.profiler)")
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

    gen = torch.Generator().manual_seed(1234)
    kernels = []
    for check in (check_gather, check_commit, check_lookup, check_scatters,
                  check_insert, check_delete, check_row_loop, check_probe):
        rows = check("cuda", gen)
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
            if "rebuild_ms" in row:
                log(f"    rebuild shape: kernel {row['rebuild_ms']:.4f} ms, "
                    f"plain {row['rebuild_plain_ms']:.4f} ms")
            for extra in ("ms_w10", "ms_script_table"):
                if extra in row:
                    log(f"    {extra}: kernel {row[extra]:.4f} ms")

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

    by_path = {}
    for phase, label, model_fn, instances, per_instance, path in (
        ("4", "config1", config1_model, INSTANCES, TRANSITIONS_PER_INSTANCE,
         CONFIG1_KERNELS),
        ("5", "config3", config3_model, INSTANCES_C3, TRANSITIONS_PER_INSTANCE_C3,
         CONFIG3_KERNELS),
        ("5b", "config2", config2_model, INSTANCES_C2, TRANSITIONS_PER_INSTANCE_C2,
         CONFIG1_KERNELS),
    ):
        run = drive_path(label, model_fn, instances, per_instance, path)
        report[label] = run
        by_path[label] = run["launches"]
        log(f"[{phase}] {label}: {instances} instances, wave {WAVE}, capacity "
            f"{CAP_FACTOR * WAVE}: processed {run['totals']['processed']}, completed "
            f"{run['totals']['completed_roots']}, rounds {run['totals']['rounds']}, "
            f"no overflow, exact launches per round; "
            f"{run['transitions_per_sec']:.1f} transitions/s over the "
            f"{run['waves'] - 1} waves after the first ({run['timed_seconds']:.3f} s); "
            f"launches {run['launches']}; table-commit device launches "
            f"{run['commit_launches']['device']} for {run['commit_launches']['calls']} "
            f"commits ({run['commit_launches']['device'] / run['totals']['rounds']:.0f} "
            f"a round); device launches {run['commit_launches']['all']}")
    # phase 6: the serving path. The first engine built in this process
    # runs the boot self-check inside its constructor
    import shutil
    import tempfile

    from zeebe_tpu_torch.tpu.engine import CudaPartitionEngine

    workdir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="serve-", dir=workdir)
    try:
        if ops._SELFCHECK_PASSED:
            raise AssertionError("the boot self-check ran before the first engine")
        reset_launches()
        t0 = time.perf_counter()
        CudaPartitionEngine(0, 1, capacity=SERVE_CAPACITY)
        boot_s = time.perf_counter() - t0
        by_path["selfcheck"] = launch_counts()
        boot_commits = commit_device_launches("selfcheck")
        zero = [k for k in SELFCHECK_KERNELS if by_path["selfcheck"][k] <= 0]
        if not ops._SELFCHECK_PASSED or zero:
            raise AssertionError(f"the boot self-check did not run its kernels: {zero}")
        report["selfcheck"] = {"seconds": boot_s, "launches": by_path["selfcheck"]}
        log(f"[6] first engine on the card: boot self-check bit-equal in "
            f"{boot_s:.3f} s; launches {by_path['selfcheck']}; device launches "
            f"{boot_commits['all']}")
        served = {}
        for label, model_fn, instances, per_instance, payload, advance_ms in (
            ("config1", config1_model, SERVE_INSTANCES, TRANSITIONS_PER_INSTANCE,
             order_payload, 0),
            ("config3", config3_model, SERVE_INSTANCES_C3, TRANSITIONS_PER_INSTANCE_C3,
             order_payload, 0),
            ("config2", config2_model, SERVE_INSTANCES_C2, TRANSITIONS_PER_INSTANCE_C2,
             alternating_payload, 0),
            ("timers", timer_model, SERVE_INSTANCES_TIMER, SIGNATURE_PER_TIMER_INSTANCE,
             order_payload, 2 * TIMER_MS),
        ):
            run = serve_checked(label, model_fn, instances, per_instance, workdir,
                                payload=payload, advance_ms=advance_ms)
            served[label] = (model_fn, payload, advance_ms, run.pop("signature"))
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
                f"{run['commit_launches']['all']}")
        par = serve_parity(workdir)
        report["serving_parity"] = par
        log(f"[6b] config 1, {par['instances']} instances, {SERVE_CREDITS} credits "
            f"(a credit drought): cuda == cpu, equal log signatures "
            f"({par['signature_records']} records; cuda {par['cuda_seconds']:.3f} s, "
            f"cpu {par['cpu_seconds']:.3f} s)")
        for label in ("config2", "timers"):
            model_fn, payload, advance_ms, sig = served[label]
            par = serve_parity_with_oracle(
                label, model_fn, sig, report["serving_" + label]["instances"],
                workdir, payload=payload, advance_ms=advance_ms)
            report["serving_parity_" + label] = par
            log(f"[6b] {label}, {par['instances']} instances: the card's log "
                f"signature ({par['signature_records']} records) equal on cpu "
                f"({par['cpu_seconds']:.3f} s); with {par['instances']} credits the "
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

    if args.profile:
        report["profile_eval_programs"] = profile_eval_programs(WAVE)
        ev = report["profile_eval_programs"]
        log(f"[p] eval_programs, one call at B={WAVE}: {ev['ms']:.4f} ms, device "
            f"{ev['device_ms']:.4f} ms in {ev['device_launches']} device ops")
        for label, name, model_fn in (("profile", "config 1", config1_model),
                                      ("profile_config3", "config 3", config3_model),
                                      ("profile_config2", "config 2", config2_model)):
            prof = profile_config(WAVE, model_fn=model_fn)
            report[label] = prof
            log(f"[p] {name}, one wave of {WAVE}: {prof['rounds']} "
                f"rounds, wall {prof['wall_ms']:.1f} ms, device busy "
                f"{prof['device_busy_ms']:.1f} ms (idle share "
                f"{prof['device_idle_share']:.3f}), {prof['device_launches']} device ops")
            for row in prof["top"]:
                log(f"    {row['device_ms']:9.3f} ms {row['count']:6d}x {row['name']}")
    # launches: the sum over the main-path runs (phases 4, 5 and 5b, 6: the
    # boot self-check and the four served runs, and 7: the probe), each
    # run's own count beside it; masked_row_add, which no path calls, stays
    # at 0
    for row in kernels:
        row["launches_by_path"] = {p: c[row["name"]] for p, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    report["kernels"] = kernels
    report["card"] = smi
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
        sys.exit(1)
