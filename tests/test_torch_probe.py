"""zeebe_tpu_torch/probe.py against benchmarks/pallas_probe.py, bit for bit.

The Pallas kernels of the JAX script run in interpret mode on the CPU
(``pl.pallas_call(..., interpret=True)``, the script itself unchanged) at
the module's own sizes (B = 2^14, CAP = 2^16, K = 128); the port's plain
versions run on the CPU, which is what its wrappers dispatch CPU tensors
to. Tolerance 0: every value is an int32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from benchmarks import pallas_probe as jp
from zeebe_tpu_torch import probe as tp


def test_sizes_are_the_scripts():
    assert (tp.B, tp.CAP, tp.K) == (jp.B, jp.CAP, jp.K)


@pytest.mark.parametrize("n_writes", [1, 10])
def test_row_loop_equals_the_pallas_kernel(n_writes):
    """Random indices (about 1,700 rows named more than once), distinct
    random rows, a random table: the rows no record names must keep it."""
    rng = np.random.default_rng(n_writes)
    tbl = rng.integers(-2**31, 2**31 - 1, size=(jp.CAP, jp.K), dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, jp.CAP, size=jp.B).astype(np.int32)
    rows = rng.integers(-2**31, 2**31 - 1, size=(jp.B, jp.K), dtype=np.int64).astype(np.int32)
    assert jp.B - np.unique(idx).size > 1000  # duplicates: the last writer decides
    want = pl.pallas_call(
        functools.partial(jp._row_loop_kernel, n_writes=n_writes),
        out_shape=jax.ShapeDtypeStruct(tbl.shape, jnp.int32),
        input_output_aliases={2: 0},
        interpret=True,
    )(jnp.asarray(idx), jnp.asarray(rows), jnp.asarray(tbl))
    got = tp.row_loop(torch.from_numpy(tbl.copy()), torch.from_numpy(idx),
                      torch.from_numpy(rows), n_writes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _pallas_probe(keys, tkeys):
    return np.asarray(pl.pallas_call(
        jp._probe_kernel,
        out_shape=jax.ShapeDtypeStruct((jp.B,), jnp.int32),
        interpret=True,
    )(jnp.asarray(keys), jnp.asarray(tkeys.reshape(jp.CAP // jp.LANES, jp.LANES))))


def _script_case():
    keys = np.random.default_rng(0).integers(0, jp.CAP, size=jp.B).astype(np.int32)
    return keys, tp.script_table().numpy()


def _chained_case():
    """Half the table filled by the probe's own hash and linear probing
    (chains, some past 8 probes); half the keys present, half absent."""
    rng = np.random.default_rng(1)
    present = rng.choice(2**31 - 1, jp.CAP // 2, replace=False)
    absent = rng.integers(-2**31, 0, size=jp.B // 2)
    keys = np.concatenate([rng.choice(present, jp.B // 2), absent]).astype(np.int32)
    return keys, tp.hashed_table(present, jp.CAP)


@pytest.mark.parametrize("case", [_script_case, _chained_case],
                         ids=["script_table", "hashed_table"])
def test_probe_equals_the_pallas_kernel(case):
    keys, tkeys = case()
    want = _pallas_probe(keys, tkeys)
    got = tp.probe(torch.from_numpy(keys), torch.from_numpy(tkeys))
    np.testing.assert_array_equal(got.numpy(), want)
    hits = int((want >= 0).sum())
    if case is _chained_case:
        # hits, chain misses and keys lost past the eighth probe all occur
        assert jp.B // 4 < hits < jp.B // 2
    else:
        assert hits < 8  # the script's table holds keys away from their hash


def test_hashed_table_places_every_key_on_its_chain():
    present = np.random.default_rng(2).choice(2**31 - 1, 300, replace=False)
    table = tp.hashed_table(present, 512)
    assert sorted(table[table >= 0].tolist()) == sorted(present.tolist())


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """No kernel is built or launched for CPU tensors, and the wrappers
    return what the plain versions return."""
    monkeypatch.setattr(tp, "_entry", lambda *a: 1 / 0)
    tp.reset_launches()
    rng = np.random.default_rng(3)
    tbl = torch.from_numpy(rng.integers(0, 9, size=(64, 4)).astype(np.int32))
    idx = torch.tensor([3, 5, 3, -1, 64, 7], dtype=torch.int32)
    rows = torch.arange(24, dtype=torch.int32).reshape(6, 4)
    want = tbl.clone()
    want[5], want[3], want[7] = rows[1] + 2, rows[2] + 2, rows[5] + 2
    got = tp.row_loop(tbl.clone(), idx, rows, 3)
    assert torch.equal(got, want)
    assert torch.equal(tp.row_loop(tbl.clone(), idx, rows, 3),
                       tp.row_loop_reference(tbl.clone(), idx, rows, 3))
    tkeys = torch.from_numpy(tp.hashed_table(np.array([11, 12, 13]), 16))
    keys = torch.tensor([11, 12, 13, 14], dtype=torch.int32)
    assert torch.equal(tp.probe(keys, tkeys), tp.probe_reference(keys, tkeys))
    assert tp.probe(keys, tkeys)[-1] == -1 and (tp.probe(keys, tkeys)[:3] >= 0).all()
    assert tp.LAUNCHES == {"row_loop": 0, "probe": 0}
