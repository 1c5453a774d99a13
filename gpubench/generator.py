"""The traffic generator: one mix's parameters (``gpubench/traffic/<mix>.json``)
turned into each unit's inputs, made on the device from the seed.

A mix is a closed loop of units. A unit is a list of phases, each of which
hands the engine one batch and drives it to quiescence at ``batch_size``:

- ``{"op": "create", "count": n}``: n CREATE commands, one instance each,
  with the payload that ``payload`` draws per variable: ``distinct_below``
  (distinct whole numbers below it) or ``integers`` ([low, high]); every
  number is exact in float32;
- ``{"op": "publish", "message": m, "share": s, "variables": {...}}``: a
  PUBLISH of m for a seeded share s of the unit's instances, in a seeded
  order, keyed by each instance's correlation variable (the configuration
  names it), with boolean message variables and no time to live;
- ``{"op": "tick", "after_ms": t}``: the partition's tick t ms after the
  unit's clock, whose TRIGGER commands are the batch.

Unit u runs at the records' clock u * ``clock_step_ms``; the lookup state is
rebuilt after each unit whose index is a multiple of ``rebuild_every``. Every
seed gives every unit the same sizes and phases; the seed draws the values
and which instances a publish reaches, and in what order.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

import torch

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
F32_EXACT = 1 << 24


@dataclasses.dataclass
class UnitInputs:
    """One unit's drawn inputs: each variable's values per instance and, per
    publish phase, the instances it reaches in order."""

    variables: Dict[str, torch.Tensor]
    publish: Dict[int, torch.Tensor]


class Mix:
    def __init__(self, spec: dict, config: dict):
        self.spec = spec
        self.phases: List[dict] = spec["unit"]
        creates = [p for p in self.phases if p["op"] == "create"]
        if len(creates) != 1 or self.phases[0]["op"] != "create":
            raise ValueError("a unit starts with its one create phase")
        self.unit_size = int(creates[0]["count"])
        self.batch_size = int(spec["batch_size"])
        self.synthetic_workers = bool(spec["synthetic_workers"])
        self.clock_step_ms = int(spec["clock_step_ms"])
        self.rebuild_every = int(spec["rebuild_every"])
        self.payload = spec["payload"]
        receive = [e for e in config["graph"]["elements"] if e["type"] == "receiveTask"]
        self.correlation = {e["message"]: e["correlationKey"] for e in receive}
        for p in self.phases:
            if p["op"] not in ("create", "publish", "tick"):
                raise ValueError(f"unknown phase {p['op']}")
            if p["op"] == "publish" and p["message"] not in self.correlation:
                raise ValueError(f"no receive task waits for {p['message']}")
        for name, how in self.payload.items():
            if name not in config["variables"]:
                raise ValueError(f"{name} is not a variable of the configuration")
            if set(how) - {"distinct_below", "integers"} or len(how) != 1:
                raise ValueError(f"{name}: one of distinct_below, integers")

    def now(self, unit: int) -> int:
        return unit * self.clock_step_ms

    def inputs(self, seed: int, unit: int, device) -> UnitInputs:
        """Unit ``unit``'s inputs under ``seed``, drawn in a few calls on
        ``device`` (the same seed and unit give the same values there)."""
        gen = torch.Generator(device=device)
        gen.manual_seed((int(seed) * 1_000_003 + unit) % (1 << 63))
        n = self.unit_size
        variables = {}
        for name, how in self.payload.items():
            if "distinct_below" in how:
                top = int(how["distinct_below"])
                if top > F32_EXACT or top < n:
                    raise ValueError(f"{name}: distinct_below must lie in [count, 2^24]")
                vals = torch.randperm(top, generator=gen, device=device)[:n]
            else:
                low, high = (int(x) for x in how["integers"])
                if not (0 <= low <= high < F32_EXACT):
                    raise ValueError(f"{name}: integers must lie in [0, 2^24)")
                vals = torch.randint(low, high + 1, (n,), generator=gen, device=device)
            variables[name] = vals.to(torch.float32)
        publish = {}
        for i, p in enumerate(self.phases):
            if p["op"] == "publish":
                take = int(round(float(p["share"]) * n))
                publish[i] = torch.randperm(n, generator=gen, device=device)[:take]
        return UnitInputs(variables, publish)


def load(name: str, config: dict, directory: Optional[Path] = None) -> Mix:
    path = (directory or TRAFFIC_DIR) / f"{name}.json"
    return Mix(json.loads(path.read_text()), config)
