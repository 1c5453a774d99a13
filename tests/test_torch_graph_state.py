"""Graph compile, engine state and record batches: zeebe_tpu_torch against
zeebe_tpu, leaf by leaf (shape, dtype and value; f32 by its bits)."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zeebe_tpu.models.bpmn import builder as j_builder, model as j_model
from zeebe_tpu.models.transform.transformer import transform_model as j_transform
from zeebe_tpu.tpu import batch as jb, graph as jg, state as js
from zeebe_tpu_torch.models.bpmn import builder as t_builder, model as t_model
from zeebe_tpu_torch.models.transform.transformer import transform_model as t_transform
from zeebe_tpu_torch.tpu import batch as tb, graph as tg, state as ts
from test_torch_kernel import _assert_leaf, jax_state, jax_state_np


# --- the same models on both sides (builder modules passed in) ------------


def _order(bm, mm):
    return (bm.Bpmn.create_process("order-process").start_event("start")
            .service_task("collect-money", type="payment-service")
            .end_event("end").done())


def _xor(bm, mm):
    builder = bm.Bpmn.create_process("xor-process").start_event("start").exclusive_gateway("split")
    builder.branch('$.orderValue > 50').service_task("big", type="payment-service").end_event("end-big")
    builder.branch(default=True).service_task("small", type="payment-service").end_event("end-small")
    return builder.done()


def _forkjoin(bm, mm):
    builder = bm.Bpmn.create_process("fork-process").start_event("start").parallel_gateway("fork")
    join = mm.ParallelGateway(id="join")
    join.scope_id = "fork-process"
    builder.model.add(join)
    builder.branch().service_task("task-a", type="payment-service").connect_to("join")
    builder.branch().service_task("task-b", type="payment-service").connect_to("join")
    builder.move_to("join").end_event("end")
    return builder.done()


def _fork3(bm, mm):
    """A parallel split into three branches that never join."""
    builder = bm.Bpmn.create_process("fork3").start_event("start").parallel_gateway("fork")
    for name in ("a", "b", "c"):
        builder.branch().service_task(f"task-{name}", type="payment-service").end_event(f"end-{name}")
    return builder.done()


def _boundary(bm, mm):
    return (bm.Bpmn.create_process("c4").start_event("start")
            .receive_task("wait-pay", message_name="paid", correlation_key="$.oid")
            .boundary_event("deadline", duration_ms=30_000).end_event("expired")
            .move_to("wait-pay").end_event("done").done())


def _multi(bm, mm):
    builder = bm.Bpmn.create_process("c5")
    sub = builder.start_event("start").sub_process("each", multi_instance={"cardinality": 4})
    sub.start_event("s").service_task("work", type="payment-service").end_event("e")
    return sub.embedded_done().end_event("done").done()


MODELS = [_order, _xor, _forkjoin, _fork3, _boundary, _multi]


def compile_both(build, device="cpu"):
    jw = j_transform(build(j_builder, j_model))
    tw = t_transform(build(t_builder, t_model))
    for w in jw + tw:
        w.key, w.version = 9, 1
    jgraph, jmeta = jg.compile_graph(jw)
    tgraph, tmeta = tg.compile_graph(tw, device=device)
    return (jgraph, jmeta), (tgraph, tmeta)


@pytest.mark.parametrize("build", MODELS, ids=lambda f: f.__name__.strip("_"))
def test_compile_graph_every_leaf_equal(build):
    (jgraph, jmeta), (tgraph, tmeta) = compile_both(build)
    for name in tg.DATA_FIELDS:
        _assert_leaf(name, getattr(tgraph, name).numpy(), getattr(jgraph, name))
    for name in tg.STATIC_FIELDS:
        assert getattr(tgraph, name) == getattr(jgraph, name), name
    assert tmeta.varspace.names == jmeta.varspace.names
    assert tmeta.elem_ids == jmeta.elem_ids and tmeta.slot_by_key == jmeta.slot_by_key
    assert [tmeta.interns.string(i) for i in range(len(tmeta.interns))] == \
        [jmeta.interns.string(i) for i in range(len(jmeta.interns))]
    for jw, tw in zip(jmeta.workflows, tmeta.workflows):
        assert tg.check_device_compatible(tw) == jg.check_device_compatible(jw)


def test_graph_numpy_round_trip():
    (jgraph, _), (tgraph, _) = compile_both(_boundary)
    fields = {n: np.asarray(getattr(jgraph, n)) for n in tg.DATA_FIELDS}
    fields.update({n: getattr(jgraph, n) for n in tg.STATIC_FIELDS})
    back = tg.graph_to_numpy(tg.graph_from_numpy(fields, device="cpu"))
    for name in tg.DATA_FIELDS:
        _assert_leaf(name, back[name], fields[name])
    assert {n: back[n] for n in tg.STATIC_FIELDS} == {n: fields[n] for n in tg.STATIC_FIELDS}


@pytest.mark.parametrize("kwargs", [
    dict(capacity=1024, num_vars=8),
    dict(capacity=512, num_vars=3, job_capacity=256, sub_capacity=8),
    dict(capacity=2048, num_vars=8, join_capacity=2048, timer_capacity=300,
         msub_capacity=100, msg_capacity=70, max_join_in=3),
])
def test_make_state_every_leaf_equal(kwargs):
    want = jax_state_np(js.make_state(**kwargs))
    got = ts.state_to_numpy(ts.make_state(**kwargs, device="cpu"))
    assert sorted(got) == sorted(want)
    for name in want:
        _assert_leaf(name, got[name], want[name])


def _populated_state(rng, n=256, v=4):
    """A JAX-layout state with random live rows whose stride-5 keys collide
    in the direct-mapped index (congruent mod 8N) and in the hash maps."""
    arrays = jax_state_np(js.make_state(capacity=n, num_vars=v, sub_capacity=8))
    live = rng.random(n) < 0.6
    k = rng.integers(0, 64, size=n) * (8 * n) + rng.integers(0, 40, size=n)
    arrays["ei_i64"][:, 0] = np.where(live, 5 * k + 1, -1)
    arrays["ei_i32"][:, 1] = np.where(live, rng.integers(0, 12, size=n), -1)
    jlive = rng.random(n) < 0.5
    arrays["job_i64"][:, 0] = np.where(jlive, 5 * rng.integers(0, 10**6, size=n) + 2, -1)
    arrays["job_i32"][:, 0] = np.where(jlive, 1, -1)
    tk = arrays["timer_key"]
    tk[: tk.shape[0] // 3] = 5 * np.arange(tk.shape[0] // 3) + 3
    return arrays


def test_rebuild_lookup_state_equal():
    arrays = _populated_state(np.random.default_rng(2))
    want = jax_state_np(js.rebuild_lookup_state(jax_state(arrays)))
    got = ts.state_to_numpy(ts.rebuild_lookup_state(ts.state_from_numpy(arrays, device="cpu")))
    for name in want:
        _assert_leaf(name, got[name], want[name])


def test_state_numpy_round_trip():
    arrays = _populated_state(np.random.default_rng(3))
    state = ts.state_from_numpy(arrays, device="cpu")
    assert state.free_ei_pop.dim() == 0 and state.ei_map.keys.dtype == torch.int64
    back = ts.state_to_numpy(state)
    for name in arrays:
        _assert_leaf(name, back[name], arrays[name])


def test_payload_pack_unpack_and_corr_composite_bits():
    rng = np.random.default_rng(4)
    vt = rng.integers(0, 6, size=(32, 5)).astype(np.int8)
    sid = rng.integers(0, 10**6, size=(32, 5)).astype(np.int32)
    num = rng.integers(-2**31, 2**31 - 1, size=(32, 5), dtype=np.int64).astype(np.int32)
    num[0] = [0x7FC00001, 0x7F800001, -1, 0x7F800000, -0x80000000]
    num = num.view(np.float32)
    want = js.pack_payload(jnp.asarray(vt), jnp.asarray(sid), jnp.asarray(num))
    got = ts.pack_payload(torch.from_numpy(vt), torch.from_numpy(sid), torch.from_numpy(num))
    _assert_leaf("pack", got.numpy(), want)
    for name, g, w in zip(("vt", "sid", "num"), ts.unpack_payload(got), js.unpack_payload(want)):
        _assert_leaf(name, g.numpy(), w)
    bits = sid.view(np.int32) - 2**30
    want = js.corr_composite(jnp.asarray(sid[:, 0]), jnp.asarray(vt[:, 0]), jnp.asarray(bits[:, 0]))
    got = ts.corr_composite(torch.from_numpy(sid[:, 0]), torch.from_numpy(vt[:, 0]),
                            torch.from_numpy(bits[:, 0]))
    _assert_leaf("corr", got.numpy(), want)


def _random_batch(rng, size, v):
    nan = rng.integers(-2**31, 2**31 - 1, size=(size, v), dtype=np.int64).astype(np.int32)
    nan[0, 0] = 0x7FC00001
    cols = {}
    for name in tb.FIELDS:
        ref = getattr(jb.empty(1, v), name)
        dt = np.asarray(ref).dtype
        shape = (size, v) if ref.ndim == 2 else (size,)
        if dt == np.bool_:
            cols[name] = rng.random(shape) < 0.5
        elif dt == np.float32:
            cols[name] = nan.view(np.float32)
        else:
            info = np.iinfo(dt)
            cols[name] = rng.integers(info.min, info.max, size=shape, dtype=np.int64).astype(dt)
    return cols


def test_take_rows_and_compact_equal():
    rng = np.random.default_rng(5)
    cols = _random_batch(rng, 96, 6)
    jbatch = jb.RecordBatch(**{k: jnp.asarray(a) for k, a in cols.items()})
    tbatch = tb.batch_from_numpy(cols, device="cpu")
    idx = rng.integers(0, 96, size=96).astype(np.int32)
    idx[:3] = [-1, 95, 0]
    for j_out, t_out in (
        (jb.take_rows(jbatch, jnp.asarray(idx)), tb.take_rows(tbatch, torch.from_numpy(idx))),
        (jb.compact(jbatch), tb.compact(tbatch)),
    ):
        for name in tb.FIELDS:
            _assert_leaf(name, getattr(t_out, name).numpy(), getattr(j_out, name))


def test_empty_batch_equal():
    want = jb.empty(40, 7)
    got = tb.empty(40, 7, device="cpu")
    for name in tb.FIELDS:
        _assert_leaf(name, getattr(got, name).numpy(), getattr(want, name))
    assert dataclasses.fields(tb.RecordBatch)[0].name == "valid"
