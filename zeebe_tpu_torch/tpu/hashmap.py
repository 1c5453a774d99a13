"""Device open-addressing hash table: int64 key → int32 slot.

PyTorch counterpart of ``zeebe_tpu.tpu.hashmap`` (reference:
``zb-map/src/main/java/io/zeebe/map/ZbMap.java:37``): a pair of tensors
(keys, vals), capacity a power of two, linear probing, batched ops:

- ``lookup``: probe loop, all queries in parallel (the plain version; the
  step kernel calls ``ops.lookup``, which launches the CUDA kernel for
  CUDA tensors).
- ``insert``: deterministic parallel claims — per probe round, each
  pending insert scatters its batch rank onto its candidate bucket with
  scatter-min; the unique winner writes, losers advance their probe. The
  bucket layout equals the JAX package's XLA path, not just the key→value
  map. Assumes batch keys are unique.
- ``delete``: probe to the key's bucket, write a tombstone.

Functional like the JAX version: every op returns new tensors.
"""

from __future__ import annotations

import dataclasses

import torch

EMPTY = -1
TOMBSTONE = -2
MAX_PROBES = 32
REBUILD_LOAD = 0.45

_BIG = 2**31 - 1
_U32 = 0xFFFFFFFF


@dataclasses.dataclass
class HashTable:
    keys: torch.Tensor  # [T] int64; EMPTY / TOMBSTONE sentinels
    vals: torch.Tensor  # [T] int32


def make(capacity: int, device=None) -> HashTable:
    assert capacity & (capacity - 1) == 0, "capacity must be a power of two"
    return HashTable(
        keys=torch.full((capacity,), EMPTY, dtype=torch.int64, device=device),
        vals=torch.zeros((capacity,), dtype=torch.int32, device=device),
    )


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64, without int64
    overflow: c is split into 16-bit halves."""
    lo16, hi16 = c & 0xFFFF, c >> 16
    return (x * lo16 + (((x * hi16) & 0xFFFF) << 16)) & _U32


def _hash(keys: torch.Tensor, table_size: int) -> torch.Tensor:
    """Bit-identical to ``zeebe_tpu.tpu.hashmap._hash``: multiplicative hash
    over the two 32-bit halves in uint32 arithmetic, here carried in int64
    masked to 32 bits (PyTorch on the CPU has no ``>>`` for uint32)."""
    keys = keys.to(torch.int64)
    lo = keys & _U32
    hi = (keys >> 32) & _U32
    h = _mul_u32(lo, 0x9E3779B1) ^ _mul_u32(hi, 0x85EBCA77)
    h = h ^ (h >> 15)
    return (h & (table_size - 1)).to(torch.int32)


def lookup(table: HashTable, keys: torch.Tensor, valid: torch.Tensor):
    """Batched lookup. Returns (found [B] bool, vals [B] int32)."""
    table_size = table.keys.shape[0]
    h0 = _hash(keys, table_size)
    keys = keys.to(torch.int64)
    found = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    vals = torch.full(keys.shape, -1, dtype=torch.int32, device=keys.device)
    done = ~valid
    for i in range(MAX_PROBES):
        if bool(done.all()):
            break
        idx = (h0 + i) & (table_size - 1)
        k = table.keys[idx]
        hit = (~done) & (k == keys)
        found = found | hit
        vals = torch.where(hit, table.vals[idx], vals)
        # an EMPTY bucket terminates the chain; TOMBSTONE does not
        done = done | hit | (k == EMPTY)
    return found, vals


def insert(table: HashTable, keys: torch.Tensor, vals: torch.Tensor,
           valid: torch.Tensor):
    """Batched insert of unique keys. Returns (table', inserted [B] bool).

    ``inserted`` is False for entries that could not be placed within
    MAX_PROBES (over-full table) — the engine must rebuild larger then.
    """
    table_size = table.keys.shape[0]
    batch = keys.shape[0]
    dev = keys.device
    keys = keys.to(torch.int64)
    vals = vals.to(torch.int32)
    h0 = _hash(keys, table_size)
    rank = torch.arange(batch, dtype=torch.int32, device=dev)
    tkeys = table.keys.clone()
    tvals = table.vals.clone()
    pending = valid.clone()
    probe = torch.zeros((batch,), dtype=torch.int32, device=dev)
    for _ in range(MAX_PROBES):
        if not bool(pending.any()):
            break
        idx = ((h0 + probe) & (table_size - 1)).to(torch.int64)
        # claim EMPTY *or* TOMBSTONE buckets (standard open addressing)
        free = tkeys[idx] < 0
        attempt = pending & free
        # deterministic bucket claim: lowest batch rank wins
        order = torch.where(attempt, rank, _BIG)
        claims = torch.full((table_size,), _BIG, dtype=torch.int32, device=dev)
        claims.scatter_reduce_(0, idx, order, reduce="amin", include_self=True)
        win = attempt & (claims[idx] == rank)
        widx = idx[win]  # one winner per bucket: the targets are unique
        tkeys[widx] = keys[win]
        tvals[widx] = vals[win]
        pending = pending & ~win
        probe = torch.where(pending, probe + 1, probe)
    return HashTable(tkeys, tvals), valid & ~pending


def delete(table: HashTable, keys: torch.Tensor, valid: torch.Tensor) -> HashTable:
    """Batched delete: the key's bucket becomes a tombstone."""
    table_size = table.keys.shape[0]
    h0 = _hash(keys, table_size)
    keys = keys.to(torch.int64)
    slot = torch.full(keys.shape, table_size, dtype=torch.int32,
                      device=keys.device)
    done = ~valid
    for i in range(MAX_PROBES):
        if bool(done.all()):
            break
        idx = (h0 + i) & (table_size - 1)
        k = table.keys[idx]
        hit = (~done) & (k == keys)
        slot = torch.where(hit, idx, slot)
        done = done | hit | (k == EMPTY)
    tkeys = table.keys.clone()
    live = slot < table_size  # slot == T is the dropped sentinel
    tkeys[slot[live].to(torch.int64)] = TOMBSTONE
    return HashTable(tkeys, table.vals.clone())


def rebuild_from(capacity: int, keys: torch.Tensor, vals: torch.Tensor,
                 valid: torch.Tensor):
    """Fresh table from live entries (tombstone purge / growth).

    Returns (table, all_inserted bool scalar tensor).
    """
    table = make(capacity, device=keys.device)
    table, inserted = insert(table, keys, vals, valid)
    return table, torch.all(inserted == valid)


def fill_counts(table: HashTable):
    """(live, dead) bucket counts — host uses these to decide on rebuilds."""
    live = torch.sum(table.keys >= 0)
    dead = torch.sum(table.keys == TOMBSTONE)
    return live, dead
