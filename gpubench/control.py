"""Controls and faults: the step the window drives, broken underneath the
harness, so that ``correct`` has to come out false.

    python3 -m gpubench.control --control bf16-payload --workload <cell> --seed <n> --seconds <s>

runs the cell as ``gpubench.run`` does, with the step's output broken as
named, and prints the numbers compared and ``correct``. The benchmark's
own runs never install one. ``gpubench/tests/test_gpubench_faults.py`` runs
each on the CPU at a small size.

- ``bf16-payload``: the control. The configurations state float32 payload
  numbers carried exactly; the step's emitted payload numbers go through
  bfloat16, the precision below, as a step that halved its payload bytes
  would.
- ``bf16-payload-at-end``: the same, in the records of the graph's end
  events only. A message's correlation value is payload too, and distinct
  values collide in bfloat16, so the step rounded everywhere overflows its
  tables (message-timer) before a number is compared; at an end event
  nothing correlates any more, and the rounded payload reaches the
  comparison.
- ``state-unchanged``: each step returns the state it was given.
- ``half-batch``: each step sees only the first half of its batch; the rest
  is dropped.
- ``altered-record``: one emitted record a step gets a wrong intent, where
  it is produced.
- ``drop-exchange``: the lockstep drive of several partitions
  (``tpu.shard.build_sharded_drive``) loses every record it routes to
  another partition: the exchange between partitions, and between cards
  where they lie on several, left out. A configuration of one partition,
  or one whose graph has no message step, has no exchange to leave out.

Each control of the step breaks both steps a drive may call: the one
``tpu.drive`` calls and the one ``tpu.shard``'s lockstep drive calls.
"""

from __future__ import annotations

import argparse
import json
import sys


def _bf16_payload(step, rows=None):
    import torch

    def wrapped(graph, *args, **kwargs):
        state, out, stats = step(graph, *args, **kwargs)
        low = out.v_num.to(torch.bfloat16).to(torch.float32)
        if rows is not None:
            low = torch.where(rows(graph, out)[:, None], low, out.v_num)
        out.v_num.copy_(low)
        return state, out, stats
    return wrapped


def _at_end_events(graph, out):
    from zeebe_tpu_torch.models.bpmn.model import ElementType

    types = graph.elem_type
    kind = types[out.wf.long().clamp(0, types.shape[0] - 1),
                 out.elem.long().clamp(0, types.shape[1] - 1)]
    return out.valid & (kind == int(ElementType.END_EVENT))


def _state_unchanged(step):
    from zeebe_tpu_torch.tpu import state as state_mod

    def wrapped(graph, state, *args, **kwargs):
        kept = state_mod.state_from_numpy(state_mod.state_to_numpy(state), device=state.device)
        _new, out, stats = step(graph, state, *args, **kwargs)
        return kept, out, stats
    return wrapped


def _half_batch(step):
    def wrapped(graph, state, batch, *args, **kwargs):
        batch.valid[batch.size // 2:] = False
        return step(graph, state, batch, *args, **kwargs)
    return wrapped


def _altered_record(step):
    def wrapped(*args, **kwargs):
        state, out, stats = step(*args, **kwargs)
        out.intent[0] += 1
        return state, out, stats
    return wrapped


def _drop_exchange(route):
    import torch

    def wrapped(out, nparts, my_pid):
        to = route(out, nparts, my_pid)
        return torch.where(to == my_pid, to, torch.full_like(to, -1))
    return wrapped


# controls of the step, and of the exchange between partitions
CONTROLS = {
    "bf16-payload": _bf16_payload,
    "bf16-payload-at-end": lambda step: _bf16_payload(step, _at_end_events),
    "state-unchanged": _state_unchanged,
    "half-batch": _half_batch,
    "altered-record": _altered_record,
}
EXCHANGE_CONTROLS = {"drop-exchange": _drop_exchange}


def install(name: str):
    """Break the steps that ``tpu.drive`` and ``tpu.shard`` call, or the
    routing of ``tpu.shard``'s lockstep drive; returns the undo."""
    import zeebe_tpu_torch.tpu.drive as drive
    from zeebe_tpu_torch.tpu import shard

    if name in EXCHANGE_CONTROLS:
        broken = [(shard, "correlation_route", EXCHANGE_CONTROLS[name])]
    else:
        broken = [(m, "step_kernel", CONTROLS[name]) for m in (drive, shard)]
    saved = [(m, attr, getattr(m, attr)) for m, attr, _ in broken]
    for m, attr, wrap in broken:
        setattr(m, attr, wrap(getattr(m, attr)))

    def undo():
        for m, attr, fn in saved:
            setattr(m, attr, fn)
    return undo


def correct(checks: dict) -> bool:
    """``correct`` as ``gpubench.run`` decides it: every number compared at
    its limit 0, and each over something (a check of nothing fails)."""
    return all(bad == 0 and total > 0 for bad, total, _detail in checks.values())


def main(argv=None) -> int:
    from gpubench import run as bench

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--control", required=True,
                    choices=sorted(CONTROLS) + sorted(EXCHANGE_CONTROLS))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    bench.cache_env(bench.ROOT)
    undo = install(args.control)
    try:
        res = bench.run(args.workload, args.seed, args.seconds, False)
    finally:
        undo()
    checks = res["checks"]
    for name, (bad, total, detail) in checks.items():
        print(f"{name}: {bad} of {total} differ, limit 0" + (f" ({detail})" if bad else ""),
              file=sys.stderr)
    print(json.dumps({"control": args.control, "workload": args.workload, "seed": args.seed,
                      "correct": correct(checks),
                      "checks": {k: {"value": v[0], "limit": 0, "of": v[1]}
                                 for k, v in checks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
