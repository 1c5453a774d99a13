#!/bin/bash
# chip_smoke.py's leg 8a (cluster_serve, [engine] type = "cuda") alone, a
# parent checkout and this tree in turns on one card: parent, change, change,
# parent, parent, change. Unpack the parent first, into a directory
# .gitignore lists:
#   mkdir -p build/parent && git archive PARENT | tar -x -C build/parent
#   bash tools/ab_8a.sh [build/parent]    # on a machine with one H100
# Each run prints one "AB <side> {records_per_sec, ..., p99_latency_ms}" line.
set -e
ROOT=$(pwd)
PARENT=$(cd "${1:-build/parent}" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for side in parent change change parent parent change; do
  if [ "$side" = parent ]; then D=$PARENT; else D=$ROOT; fi
  (cd "$D" && SIDE=$side python3 - <<'PY'
import json, os, sys, tempfile
sys.path.insert(0, os.getcwd())
import chip_smoke as c
from zeebe_tpu_torch import _build
_build.build_all()
r = c.cluster_serve("cuda", tempfile.mkdtemp())
keys = ("records_per_sec", "instances_per_sec", "p50_latency_ms", "p99_latency_ms",
        "elapsed_seconds", "waves")
print("AB", os.environ["SIDE"], json.dumps({k: r[k] for k in keys}), flush=True)
PY
  )
done
