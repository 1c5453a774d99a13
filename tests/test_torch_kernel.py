"""zeebe_tpu_torch step kernel against zeebe_tpu's, bit for bit.

The JAX side runs as the JAX package's CPU tests run it (jit on the CPU,
``pallas_ops`` on its XLA fallback); the port runs on the CPU with the
kernels' plain versions. The same numpy inputs feed both; state,
emissions and stats are compared leaf by leaf. The conversion helpers
here are shared with the other ``test_torch_*`` files.
"""


import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
import chip_smoke
from zeebe_tpu.tpu import batch as jb, kernel as jk, state as js
from zeebe_tpu_torch.protocol.enums import RecordType
from zeebe_tpu_torch.tpu import batch as tb, graph as tg, kernel as tk
from zeebe_tpu_torch.tpu import state as ts

_jstep = jax.jit(jk.step_kernel, static_argnames=("synthetic_workers",))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_leaf(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)


def jax_state_np(state):
    out = {}
    for f in ts.STATE_FIELDS:
        v = getattr(state, f)
        if f in ts.MAP_FIELDS:
            out[f + ".keys"] = np.array(v.keys)
            out[f + ".vals"] = np.array(v.vals)
        else:
            out[f] = np.array(v)
    return out


def jax_state(arrays):
    fields = {}
    for f in ts.STATE_FIELDS:
        if f in ts.MAP_FIELDS:
            fields[f] = js.hashmap.HashTable(jnp.asarray(arrays[f + ".keys"]),
                                             jnp.asarray(arrays[f + ".vals"]))
        else:
            fields[f] = jnp.asarray(arrays[f])
    return js.EngineState(**fields)


def port_graph(jgraph):
    fields = {n: np.asarray(getattr(jgraph, n)) for n in tg.DATA_FIELDS}
    fields.update({n: getattr(jgraph, n) for n in tg.STATIC_FIELDS})
    return tg.graph_from_numpy(fields, device="cpu")


def port_batch(jbatch):
    return tb.batch_from_numpy({n: np.asarray(getattr(jbatch, n)) for n in tb.FIELDS},
                               device="cpu")


def assert_step_equal(j_out, t_out):
    (jstate, jemit, jstats), (tstate, temit, tstats) = j_out, t_out
    want = jax_state_np(jstate)
    got = ts.state_to_numpy(tstate)
    for name in want:
        _assert_leaf(name, got[name], want[name])
    for name in tb.FIELDS:
        _assert_leaf(name, getattr(temit, name).numpy(), getattr(jemit, name))
    assert sorted(tstats) == sorted(jstats)
    for name in jstats:
        _assert_leaf(name, tstats[name].numpy(), jstats[name])


def both_steps(jgraph, arrays, jbatch, now, synthetic_workers=False):
    j_out = _jstep(jgraph, jax_state(arrays), jbatch, jnp.asarray(now, jnp.int64),
                   synthetic_workers=synthetic_workers)
    t_out = tk.step_kernel(port_graph(jgraph), ts.state_from_numpy(arrays, device="cpu"),
                           port_batch(jbatch), now, synthetic_workers=synthetic_workers)
    return j_out, t_out


# ---------------------------------------------------------------------------
# helpers: both branches (B <= 2048 triangle, B > 2048 scatter / sort)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [256, 4096])
def test_row_order_helpers_match_jax(size):
    rng = np.random.default_rng(size)
    slots = rng.integers(0, size // 16, size=size).astype(np.int32)
    mask = rng.random(size) < 0.6
    keys = rng.integers(0, size // 8, size=size).astype(np.int64) * 5 + 1
    avail = rng.random(size) < 0.3
    cases = [
        (jk._last_writer(jnp.asarray(slots), jnp.asarray(mask), size // 16),
         tk._last_writer(torch.from_numpy(slots), torch.from_numpy(mask), size // 16)),
        (jk._first_per_key(jnp.asarray(keys), jnp.asarray(mask)),
         tk._first_per_key(torch.from_numpy(keys), torch.from_numpy(mask))),
        (jk._first_true_indices(jnp.asarray(avail), size // 4),
         tk._first_true_indices(torch.from_numpy(avail), size // 4)),
        (jk._excl_cumsum(jnp.asarray(mask.astype(np.int32))),
         tk._excl_cumsum(torch.from_numpy(mask.astype(np.int32)))),
    ]
    for i, (want, got) in enumerate(cases):
        _assert_leaf(f"helper {i}", got.numpy(), want)


# ---------------------------------------------------------------------------
# one step
# ---------------------------------------------------------------------------


def test_step_on_entry_inputs():
    """The flagship step of ``__graft_entry__.entry()``: capacity 1024,
    B = 256, 64 CREATE commands."""
    _fn, (jgraph, jstate, jbatch, _now) = graft.entry()
    out = both_steps(jgraph, jax_state_np(jstate), jbatch, 0)
    assert_step_equal(*out)
    assert int(out[1][2]["emitted"]) == 128


@pytest.mark.parametrize("capacity,size,synthetic", [(1024, 256, False), (8192, 4096, True)])
def test_step_mixed_commands_and_events(capacity, size, synthetic):
    """Job state machine (accept/reject paths, activation credits, credit
    return), job events, timer commands without a timer table, guards on
    workflow-instance events; B = 4096 takes the large-batch branches."""
    _fn, (jgraph, _s, _b, _n) = graft.entry()
    arrays, cols = chip_smoke.mixed_case(np.random.default_rng(size), capacity, size)
    jbatch = jb.RecordBatch(**{n: jnp.asarray(a) for n, a in cols.items()})
    j_out, t_out = both_steps(jgraph, arrays, jbatch, 5_000, synthetic_workers=synthetic)
    assert_step_equal(j_out, t_out)
    rej = t_out[1].rtype[t_out[1].valid] == int(RecordType.COMMAND_REJECTION)
    assert int(rej.sum()) > 0 and int(t_out[2]["emitted"]) > size // 4
