"""The step engine on tensors (PyTorch counterpart of ``zeebe_tpu.tpu``).

Module map:

- ``intern``     — host string interning (ids are what the device sees)
- ``hashmap``    — open-addressing i64→i32 hash table
- ``conditions`` — value-type constants and the condition program pool
- ``graph``      — ExecutableWorkflow set → tensor tables
- ``state``      — engine state tables
- ``ops``        — the hand-written CUDA kernels and their plain versions
- ``batch``      — columnar record batches
- ``kernel``     — the step kernel
- ``drive``      — device record FIFO + drive loop

Keys are int64 throughout; PyTorch has native int64, so no switch is needed.
Importing this package needs neither a GPU nor ``nvcc``: kernels are built
at their first launch (``zeebe_tpu_torch._build``).
"""
