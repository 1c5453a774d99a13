"""Timer catch events (the ``has_timers`` gate) in the zeebe_tpu_torch step
kernel against zeebe_tpu's, bit for bit, on the CPU with the kernels'
plain versions, on start → 10 s timer catch → service task → end:

- CREATE waves walked round by round until every instance waits on its
  timer: TIMER CREATE lands in the timer table and the timer map;
- one batch of TRIGGERs of live timers, a TRIGGER of an unknown key
  (rejected), two CANCEL rows for one key (only the first cancels), a
  TRIGGER and a CANCEL of one key, then the walk on to the end;
- more timers created in one batch than the timer table has free slots
  (the overflow flag, the dropped slot).

Each round: state, emissions and stats equal; tolerance 0.
"""

import numpy as np
import pytest

from test_torch_conditions import NUM_VARS, _creates, _state, _with_vars, walk
from test_torch_drive import _subscribed
from test_torch_kernel import assert_step_equal, both_steps, jax_state_np
from zeebe_tpu.models.bpmn.builder import Bpmn as JBpmn
from zeebe_tpu.models.transform.transformer import transform_model as jtransform
from zeebe_tpu.tpu import batch as jb, graph as jg, state as js
from zeebe_tpu_torch.protocol.enums import RecordType, ValueType
from zeebe_tpu_torch.protocol.intents import TimerIntent as TI
from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI
from zeebe_tpu_torch.tpu import batch as tb, graph as tg

NOW = 1_000_000
DURATION = 10_000


@pytest.fixture(scope="module")
def timed():
    model = (
        JBpmn.create_process("timed")
        .start_event("start")
        .timer_catch_event("wait", duration_ms=DURATION)
        .service_task("after", type="payment-service")
        .end_event("end")
        .done()
    )
    workflows = jtransform(model)
    for w in workflows:
        w.key, w.version = 9, 1
    jgraph, meta = jg.compile_graph(workflows)
    jgraph = _with_vars(jgraph, meta)
    assert [g for g in tg.FEATURE_GATES if getattr(jgraph, g)] == ["has_timers"]
    return jgraph, meta


def _count(emitted, vtype, intent, rtype=int(RecordType.EVENT)):
    return sum(int((e["valid"] & (e["vtype"] == int(vtype)) & (e["rtype"] == rtype)
                    & (e["intent"] == int(intent))).sum()) for e in emitted)


def _timer_batch(arrays, rows):
    """A batch of TIMER commands staged as the engine stages them (key,
    activity instance, instance, due date, handler element): ``rows`` is
    a list of (intent, timer slot or None for an unknown key)."""
    cols = tb.batch_to_numpy(tb.empty(32, NUM_VARS, device="cpu"))
    for i, (intent, slot) in enumerate(rows):
        cols["valid"][i] = True
        cols["rtype"][i] = int(RecordType.COMMAND)
        cols["vtype"][i] = int(ValueType.TIMER)
        cols["intent"][i] = int(intent)
        if slot is None:
            cols["key"][i] = 5 * 10**9 + 3  # no timer has this key
            continue
        cols["key"][i] = arrays["timer_key"][slot]
        cols["aux_key"][i] = arrays["timer_aik"][slot]
        cols["instance_key"][i] = arrays["timer_instance_key"][slot]
        cols["deadline"][i] = arrays["timer_due"][slot]
        cols["wf"][i] = arrays["timer_wf"][slot]
        cols["elem"][i] = arrays["timer_elem"][slot]
    return jb.RecordBatch(**cols)


def test_timer_create_trigger_cancel_round_by_round(timed):
    jgraph, meta = timed
    n = 12
    jstate, emitted, over = walk(jgraph, _state(meta, 256),
                                 _creates(meta, n, 6, ("orderValue", [1.0])), 8, 60, now=NOW)
    assert over == 0
    assert _count(emitted, ValueType.TIMER, TI.CREATED) == n
    arrays = jax_state_np(jstate)
    live = np.nonzero(arrays["timer_key"] >= 0)[0]
    assert len(live) == n and (arrays["timer_due"][live] == NOW + DURATION).all()
    assert (arrays["timer_map.keys"] >= 0).sum() == n

    rows = [(TI.TRIGGER, live[0]), (TI.TRIGGER, None),
            (TI.CANCEL, live[1]), (TI.CANCEL, live[1]), (TI.CANCEL, None),
            (TI.TRIGGER, live[2]), (TI.CANCEL, live[2])]
    rows += [(TI.TRIGGER, s) for s in live[3:]]
    j_out, t_out = both_steps(jgraph, arrays, _timer_batch(arrays, rows), NOW + DURATION,
                              synthetic_workers=True)
    assert_step_equal(j_out, t_out)
    out = {name: getattr(t_out[1], name).numpy() for name in tb.FIELDS}
    assert _count([out], ValueType.TIMER, TI.TRIGGERED) == n - 1
    assert _count([out], ValueType.TIMER, TI.CANCELED) == 2  # the 2nd cancel is a no-op
    assert _count([out], ValueType.TIMER, TI.TRIGGER,
                  rtype=int(RecordType.COMMAND_REJECTION)) == 1
    assert int((t_out[0].timer_key >= 0).sum()) == 0

    # the triggered catch events complete and their instances run to the end
    jstate, emitted, over = walk(jgraph, j_out[0], j_out[1], 8, 80, now=NOW + DURATION)
    assert over == 0
    roots = sum(int((e["valid"] & (e["vtype"] == int(ValueType.WORKFLOW_INSTANCE))
                     & (e["intent"] == int(WI.ELEMENT_COMPLETED))
                     & (e["elem"] == 0)).sum()) for e in emitted)
    # the instance whose timer was only cancelled keeps waiting; the one
    # triggered and cancelled in one batch went on
    assert roots == n - 1


def test_timer_table_overflow(timed):
    """Eight instances reach their timer in one batch with four timer
    slots: the step flags the overflow and drops the slot past the table."""
    jgraph, meta = timed
    jstate = _subscribed(js.make_state(capacity=256, num_vars=NUM_VARS, timer_capacity=4,
                                       sub_capacity=8), meta.interns)
    _jstate, _emitted, over = walk(jgraph, jstate,
                                   _creates(meta, 8, 7, ("orderValue", [1.0])), 32, 40, now=NOW)
    assert over >= 1
