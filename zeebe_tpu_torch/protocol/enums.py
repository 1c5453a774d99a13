"""Protocol enums.

Reference parity: ``protocol/src/main/resources/protocol.xml:19-148``
(ValueType, RecordType, RejectionType, ControlMessageType, SubscriptionType)
and ``broker-core/.../incident/data/ErrorType.java``.

Values are stable wire constants: they appear in the binary record frame
(`zeebe_tpu.protocol.codec`) and as int8 columns in device record batches,
so they must never be renumbered.
"""

import enum


class RecordType(enum.IntEnum):
    EVENT = 0
    COMMAND = 1
    COMMAND_REJECTION = 2

    NULL_VAL = 255


class ValueType(enum.IntEnum):
    """Record value families (reference protocol.xml `ValueType` enum)."""

    JOB = 0
    RAFT = 1
    SUBSCRIBER = 2
    SUBSCRIPTION = 3
    DEPLOYMENT = 4
    WORKFLOW_INSTANCE = 5
    INCIDENT = 6
    NOOP = 7
    TOPIC = 8
    WORKFLOW = 9
    ID = 10
    MESSAGE = 11
    MESSAGE_SUBSCRIPTION = 12
    WORKFLOW_INSTANCE_SUBSCRIPTION = 13
    # TPU-native addition: explicit timer records (the reference drives job
    # timeouts from a polling processor; we materialize timers as records so
    # the device engine can fire them deterministically).
    TIMER = 14
    # Exporter position acks (the reference persists exporter positions in
    # broker state; here they are replicated THROUGH the log so a new raft
    # leader resumes export without gaps — the same pattern as
    # SUBSCRIPTION acks). EXPORTER records are broker-admin traffic:
    # exporters themselves never see them.
    EXPORTER = 15

    NULL_VAL = 255


class RejectionType(enum.IntEnum):
    MESSAGE_NOT_SUPPORTED = 0
    BAD_VALUE = 1
    NOT_APPLICABLE = 2
    PROCESSING_ERROR = 3

    NULL_VAL = 255


class ErrorType(enum.IntEnum):
    """Incident error types (reference incident/data/ErrorType.java)."""

    UNKNOWN = 0
    IO_MAPPING_ERROR = 1
    JOB_NO_RETRIES = 2
    CONDITION_ERROR = 3


class SubscriptionType(enum.IntEnum):
    TOPIC_SUBSCRIPTION = 0
    JOB_SUBSCRIPTION = 1

    NULL_VAL = 255


class ControlMessageType(enum.IntEnum):
    """Control-plane request types (reference protocol.xml ControlMessageType)."""

    ADD_JOB_SUBSCRIPTION = 0
    REMOVE_JOB_SUBSCRIPTION = 1
    INCREASE_JOB_SUBSCRIPTION_CREDITS = 2
    REMOVE_TOPIC_SUBSCRIPTION = 3
    REQUEST_TOPOLOGY = 4
    REQUEST_PARTITIONS = 5
    GET_WORKFLOW = 6
    LIST_WORKFLOWS = 7

    NULL_VAL = 255
