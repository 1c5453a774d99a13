"""Columnar record batches: the device form of log records.

PyTorch counterpart of ``zeebe_tpu.tpu.batch``: a batch is the columnar
image of a contiguous log range — record type / value type / intent / key
plus the value columns the kernel needs, payloads columnarized over the
graph's variable space, strings as interned ids. The kernel's output batch
IS the next input batch (plus host bookkeeping columns: source row,
response/push flags, rejection codes).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from zeebe_tpu_torch.device import DeviceLike, resolve
from zeebe_tpu_torch.tpu import ops
from zeebe_tpu_torch.tpu.conditions import (
    VT_ABSENT,
    VT_BOOL,
    VT_FLOAT,
    VT_NIL,
    VT_NUM,
    VT_STR,
    f32_exact,
)
from zeebe_tpu_torch.tpu.intern import InternTable

# ---------------------------------------------------------------------------
# rejection / incident codes (device → host reason strings)
# ---------------------------------------------------------------------------

REJ_NONE = 0
REJ_JOB_NOT_ACTIVATABLE = 1
REJ_JOB_NOT_COMPLETABLE = 2
REJ_JOB_NOT_ACTIVATED = 3
REJ_JOB_NOT_FAILED = 4
REJ_RETRIES_NOT_POSITIVE = 5
REJ_JOB_NOT_EXIST = 6
REJ_TIMER_NOT_EXIST = 7
REJ_SUB_NOT_ACTIVE = 8
REJ_MSG_DUP = 9
REJ_SUB_OCCUPIED = 10
REJ_MSG_STORE_OCCUPIED = 11

# incident error codes (emitted on INCIDENT CREATE commands)
ERR_CONDITION_NO_FLOW = 101
ERR_CONDITION_EVAL = 102
ERR_IO_MAPPING_IN = 103
ERR_IO_MAPPING_OUT = 104
ERR_JOB_NO_RETRIES = 105
ERR_CORRELATION_KEY = 106

REJECTION_REASONS = {
    REJ_JOB_NOT_ACTIVATABLE: "Job is not in one of these states: CREATED, FAILED, TIMED_OUT",
    REJ_JOB_NOT_COMPLETABLE: "Job is not in state: ACTIVATED, TIMED_OUT",
    REJ_JOB_NOT_ACTIVATED: "Job is not in state ACTIVATED",
    REJ_JOB_NOT_FAILED: "Job is not in state FAILED",
    REJ_RETRIES_NOT_POSITIVE: "Retries must be greater than 0",
    REJ_JOB_NOT_EXIST: "Job does not exist",
    REJ_TIMER_NOT_EXIST: "timer does not exist",
    REJ_SUB_NOT_ACTIVE: "activity is not active anymore",
    # REJ_MSG_DUP's reason embeds the message id — formatted in
    # engine._materialize from the interned id
    REJ_SUB_OCCUPIED: (
        "a subscription for this (message name, correlation key) is already "
        "open on this TPU-backed partition (one live subscription per key)"
    ),
    REJ_MSG_STORE_OCCUPIED: (
        "a message with this (name, correlation key) is already stored on "
        "this TPU-backed partition (one buffered message per key)"
    ),
}

FIELDS = (
    "valid", "rtype", "vtype", "intent", "key", "elem", "wf",
    "instance_key", "scope_key", "v_vt", "v_num", "v_str",
    "req", "req_stream", "aux_key", "aux2_key", "type_id", "retries",
    "deadline", "worker", "src", "resp", "push", "rej",
)


@dataclasses.dataclass
class RecordBatch:
    valid: torch.Tensor        # [B] bool
    rtype: torch.Tensor        # [B] int32 RecordType
    vtype: torch.Tensor        # [B] int32 ValueType
    intent: torch.Tensor       # [B] int32
    key: torch.Tensor          # [B] int64
    elem: torch.Tensor         # [B] int32 element index (-1 n/a)
    wf: torch.Tensor           # [B] int32 workflow slot (-1 n/a)
    instance_key: torch.Tensor  # [B] int64 workflowInstanceKey
    scope_key: torch.Tensor    # [B] int64 scopeInstanceKey
    v_vt: torch.Tensor         # [B, V] int8 payload types
    v_num: torch.Tensor        # [B, V] float32 (f32-exact by construction)
    v_str: torch.Tensor        # [B, V] int32
    req: torch.Tensor          # [B] int64 request id (-1 none)
    req_stream: torch.Tensor   # [B] int32 request stream / subscriber key
    aux_key: torch.Tensor      # [B] int64 job activityInstanceKey / incident aik / timer aik
    aux2_key: torch.Tensor     # [B] int64 incident jobKey / timer dueDate
    type_id: torch.Tensor      # [B] int32 job type (interned)
    retries: torch.Tensor      # [B] int32
    deadline: torch.Tensor     # [B] int64
    worker: torch.Tensor       # [B] int32 interned worker name
    src: torch.Tensor          # [B] int32 source row in the previous batch (-1 host)
    resp: torch.Tensor         # [B] bool respond to req at append
    push: torch.Tensor         # [B] bool push to req_stream subscriber
    rej: torch.Tensor          # [B] int32 rejection / incident code

    @property
    def size(self) -> int:
        return self.valid.shape[0]

    @property
    def num_vars(self) -> int:
        return self.v_vt.shape[1]

    @property
    def device(self) -> torch.device:
        return self.valid.device


def empty(size: int, num_vars: int, device: DeviceLike = None) -> RecordBatch:
    """An all-invalid batch on ``device`` (the CUDA card unless ``"cpu"``)."""
    dev = resolve(device)
    i64, i32 = torch.int64, torch.int32

    def neg(dtype):
        return torch.full((size,), -1, dtype=dtype, device=dev)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return RecordBatch(
        valid=zeros((size,), torch.bool),
        rtype=zeros((size,), i32),
        vtype=zeros((size,), i32),
        intent=zeros((size,), i32),
        key=neg(i64),
        elem=neg(i32),
        wf=neg(i32),
        instance_key=neg(i64),
        scope_key=neg(i64),
        v_vt=zeros((size, num_vars), torch.int8),
        v_num=zeros((size, num_vars), torch.float32),
        v_str=zeros((size, num_vars), i32),
        req=neg(i64),
        req_stream=neg(i32),
        aux_key=neg(i64),
        aux2_key=neg(i64),
        type_id=zeros((size,), i32),
        retries=zeros((size,), i32),
        deadline=neg(i64),
        worker=zeros((size,), i32),
        src=neg(i32),
        resp=zeros((size,), torch.bool),
        push=zeros((size,), torch.bool),
        rej=zeros((size,), i32),
    )


def batch_from_numpy(arrays, device: DeviceLike = None) -> RecordBatch:
    """A batch from numpy arrays keyed by field name (dtypes kept)."""
    dev = resolve(device)
    return RecordBatch(**{
        name: torch.from_numpy(np.array(arrays[name])).to(dev) for name in FIELDS
    })


def batch_to_numpy(batch: RecordBatch) -> Dict[str, np.ndarray]:
    return {name: getattr(batch, name).cpu().numpy() for name in FIELDS}


# ---------------------------------------------------------------------------
# host payload conversion
# ---------------------------------------------------------------------------


class PayloadError(ValueError):
    """Payload not columnarizable (nested document / unknown type) — the
    caller must fall back to the host oracle engine."""


def payload_to_columns(
    doc: Dict[str, Any],
    column_of,          # name -> column (VarSpace.column, growable)
    interns: InternTable,
    num_vars: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    vt = np.zeros((num_vars,), np.int8)
    num = np.zeros((num_vars,), np.float32)
    sid = np.zeros((num_vars,), np.int32)
    for name, value in doc.items():
        col = column_of(name)
        if col >= num_vars:
            raise PayloadError(f"variable space overflow: {name}")
        if value is None:
            vt[col] = VT_NIL
        elif isinstance(value, bool):
            vt[col] = VT_BOOL
            num[col] = 1.0 if value else 0.0
        elif isinstance(value, (int, float)):
            if not f32_exact(value):
                raise PayloadError(
                    f"payload number not f32-exact for {name!r}: {value!r}"
                )
            vt[col] = VT_NUM if isinstance(value, int) else VT_FLOAT
            num[col] = value
        elif isinstance(value, str):
            vt[col] = VT_STR
            sid[col] = interns.intern(value)
        else:
            raise PayloadError(f"non-scalar payload value for {name!r}: {value!r}")
    return vt, num, sid


def columns_to_payload(
    vt: np.ndarray, num: np.ndarray, sid: np.ndarray, names, interns: InternTable
) -> Dict[str, Any]:
    doc: Dict[str, Any] = {}
    for col, name in enumerate(names):
        t = int(vt[col])
        if t == VT_ABSENT:
            continue
        if t == VT_NIL:
            doc[name] = None
        elif t == VT_BOOL:
            doc[name] = bool(num[col])
        elif t == VT_NUM:
            doc[name] = int(num[col])
        elif t == VT_FLOAT:
            doc[name] = float(num[col])
        elif t == VT_STR:
            doc[name] = interns.string(int(sid[col]))
    return doc


def take_rows(batch: RecordBatch, idx: torch.Tensor) -> RecordBatch:
    """``batch[idx]`` (row take along axis 0) through ONE fused gather: each
    field is one op of the same launch, copied as raw bytes — bit-identical
    to per-field indexing (f32 NaN payloads included) with no packing of
    the fields into a shared matrix first."""
    cols = [getattr(batch, name) for name in FIELDS]
    taken = ops.fused_gather_rows(
        cols, [ops.GatherOp(i, idx) for i in range(len(cols))]
    )
    return RecordBatch(**dict(zip(FIELDS, taken)))


def compact(batch: RecordBatch) -> RecordBatch:
    """Stable-reorder a batch so valid rows form a contiguous prefix
    (drive.enqueue's precondition)."""
    order = torch.argsort((~batch.valid).to(torch.int8), stable=True)
    return take_rows(batch, order.to(torch.int32))
