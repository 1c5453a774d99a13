"""BPMN step vocabulary.

Reference parity: ``broker-core/.../workflow/model/BpmnStep.java`` (18
steps). TPU-native additions: PARALLEL_SPLIT / PARALLEL_MERGE (the reference
model supports parallel gateways but its engine does not execute them;
BASELINE.json requires fork/join), CREATE_TIMER / TRIGGER_CATCH_EVENT for
timer catch events, and TERMINATE_CATCH_EVENT for subscription teardown.

Stable ints: this enum is the ``step_table`` payload on device; the kernel
dispatches one masked branch per step id.
"""

import enum


class BpmnStep(enum.IntEnum):
    NONE = 0

    # exactly one outgoing sequence flow
    TAKE_SEQUENCE_FLOW = 1
    # end event / last element, no outgoing sequence flow
    CONSUME_TOKEN = 2
    # xor-gateway with conditions
    EXCLUSIVE_SPLIT = 3

    CREATE_JOB = 4

    APPLY_INPUT_MAPPING = 5
    APPLY_OUTPUT_MAPPING = 6

    # sequence flow taken, by target kind
    ACTIVATE_GATEWAY = 7
    START_STATEFUL_ELEMENT = 8
    TRIGGER_END_EVENT = 9

    SUBSCRIBE_TO_INTERMEDIATE_MESSAGE = 10

    # flow element containers
    TRIGGER_START_EVENT = 11
    COMPLETE_PROCESS = 12

    # termination
    TERMINATE_CONTAINED_INSTANCES = 13
    TERMINATE_JOB_TASK = 14
    TERMINATE_ELEMENT = 15
    PROPAGATE_TERMINATION = 16
    CANCEL_PROCESS = 17

    # TPU-native additions
    PARALLEL_SPLIT = 18
    PARALLEL_MERGE = 19
    CREATE_TIMER = 20
    TERMINATE_CATCH_EVENT = 21
    # multi-instance activation: spawn one body instance per item
    # (reference model MultiInstanceLoopCharacteristics; the reference
    # engine never executes it)
    MULTI_INSTANCE_SPLIT = 22


STEP_COUNT = len(BpmnStep)
