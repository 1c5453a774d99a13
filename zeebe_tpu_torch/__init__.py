"""zeebe_tpu_torch — the BPMN step engine in PyTorch for one NVIDIA H100.

A second package beside ``zeebe_tpu``: the same batched step kernel over
the same struct-of-arrays state, written with PyTorch tensors, and the
table primitives that ``zeebe_tpu`` writes in Pallas for the TPU written by
hand in CUDA C++ for Hopper (``csrc/``). The layout mirrors ``zeebe_tpu``
so each module's counterpart sits at the same relative path:

- ``protocol``, ``engine.keyspace``, ``models`` — host-side record enums,
  key strides, BPMN model/builder and the deploy-time transformer (copies
  of the framework-free modules, so this package stands alone)
- ``device``       — device pick: ``cuda`` unless the caller asks for ``cpu``
- ``tpu.hashmap``  — open-addressing i64→i32 hash table on the device
- ``tpu.graph``    — ExecutableWorkflow set → tensor tables
- ``tpu.state``    — engine state tables
- ``tpu.ops``      — gather / table-commit / hash-lookup: CUDA kernels for
  CUDA tensors, their plain PyTorch versions for CPU tensors
- ``tpu.batch``    — columnar record batches
- ``tpu.kernel``   — the step kernel
- ``tpu.drive``    — the device record FIFO and the drive loop

Entry points run on ``cuda`` unless given ``device="cpu"``; without a CUDA
device and without an explicit device they raise.
"""
