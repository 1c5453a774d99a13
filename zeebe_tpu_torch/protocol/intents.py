"""Record intents per value type.

Reference parity: ``protocol/src/main/java/io/zeebe/protocol/intent/*.java``.
Wire values match the reference exactly (they are the ``intent`` column of
device record batches and the binary frame codec).
"""

import enum

from zeebe_tpu_torch.protocol.enums import ValueType


class Intent(enum.IntEnum):
    """Base marker; concrete intents subclass IntEnum directly."""


class WorkflowInstanceIntent(enum.IntEnum):
    # Reference: protocol/.../intent/WorkflowInstanceIntent.java:19-38
    CREATE = 0
    CREATED = 1

    START_EVENT_OCCURRED = 2
    END_EVENT_OCCURRED = 3
    SEQUENCE_FLOW_TAKEN = 4
    GATEWAY_ACTIVATED = 5

    ELEMENT_READY = 6
    ELEMENT_ACTIVATED = 7
    ELEMENT_COMPLETING = 8
    ELEMENT_COMPLETED = 9
    ELEMENT_TERMINATING = 10
    ELEMENT_TERMINATED = 11

    CANCEL = 12
    CANCELING = 13

    UPDATE_PAYLOAD = 14
    PAYLOAD_UPDATED = 15

    # TPU-native extension: a boundary event attached to an activity fired
    # (the reference model defines BoundaryEvent —
    # bpmn-model/.../instance/BoundaryEvent.java — but its tech-preview
    # engine never executes one; this engine does, so the token needs a
    # lifecycle event to continue from)
    BOUNDARY_EVENT_OCCURRED = 16


# Lifecycle state sets.
# Reference: broker-core/.../workflow/processor/WorkflowInstanceLifecycle.java
ELEMENT_INSTANCE_STATES = frozenset(
    {
        WorkflowInstanceIntent.ELEMENT_READY,
        WorkflowInstanceIntent.ELEMENT_ACTIVATED,
        WorkflowInstanceIntent.ELEMENT_COMPLETING,
        WorkflowInstanceIntent.ELEMENT_COMPLETED,
        WorkflowInstanceIntent.ELEMENT_TERMINATING,
        WorkflowInstanceIntent.ELEMENT_TERMINATED,
    }
)

FINAL_ELEMENT_INSTANCE_STATES = frozenset(
    {
        WorkflowInstanceIntent.ELEMENT_COMPLETED,
        WorkflowInstanceIntent.ELEMENT_TERMINATED,
    }
)

TERMINATABLE_STATES = frozenset(
    {
        WorkflowInstanceIntent.ELEMENT_READY,
        WorkflowInstanceIntent.ELEMENT_ACTIVATED,
        WorkflowInstanceIntent.ELEMENT_COMPLETING,
    }
)


def is_initial_state(state: WorkflowInstanceIntent) -> bool:
    return state == WorkflowInstanceIntent.ELEMENT_READY


def is_final_state(state: WorkflowInstanceIntent) -> bool:
    return state in FINAL_ELEMENT_INSTANCE_STATES


def can_terminate(state: WorkflowInstanceIntent) -> bool:
    return state in TERMINATABLE_STATES


class JobIntent(enum.IntEnum):
    # Reference: protocol/.../intent/JobIntent.java:19-38
    CREATE = 0
    CREATED = 1

    ACTIVATE = 2
    ACTIVATED = 3

    COMPLETE = 4
    COMPLETED = 5

    TIME_OUT = 6
    TIMED_OUT = 7

    FAIL = 8
    FAILED = 9

    UPDATE_RETRIES = 10
    RETRIES_UPDATED = 11

    CANCEL = 12
    CANCELED = 13


class DeploymentIntent(enum.IntEnum):
    # Reference: protocol/.../intent/DeploymentIntent.java
    CREATE = 0
    CREATED = 3


class IncidentIntent(enum.IntEnum):
    # Reference: protocol/.../intent/IncidentIntent.java
    CREATE = 0
    CREATED = 1
    RESOLVE = 2
    RESOLVED = 3
    RESOLVE_FAILED = 4
    DELETE = 5
    DELETED = 6


class MessageIntent(enum.IntEnum):
    # Reference: protocol/.../intent/MessageIntent.java
    PUBLISH = 0
    PUBLISHED = 1
    DELETE = 2
    DELETED = 3


class MessageSubscriptionIntent(enum.IntEnum):
    # Reference: protocol/.../intent/MessageSubscriptionIntent.java
    OPEN = 0
    OPENED = 1
    # TPU-native additions for correlation + close lifecycle (later reference
    # versions grew these; needed for message TTL + catch-event teardown).
    CORRELATE = 2
    CORRELATED = 3
    CLOSE = 4
    CLOSED = 5


class WorkflowInstanceSubscriptionIntent(enum.IntEnum):
    # Reference: protocol/.../intent/WorkflowInstanceSubscriptionIntent.java
    CORRELATE = 0
    CORRELATED = 1


class TopicIntent(enum.IntEnum):
    # Reference: protocol/.../intent/TopicIntent.java
    CREATE = 0
    CREATING = 1
    CREATE_COMPLETE = 2
    CREATED = 3


class SubscriptionIntent(enum.IntEnum):
    # Reference: protocol/.../intent/SubscriptionIntent.java (topic-sub acks)
    ACKNOWLEDGE = 0
    ACKNOWLEDGED = 1


class SubscriberIntent(enum.IntEnum):
    # Reference: protocol/.../intent/SubscriberIntent.java
    SUBSCRIBE = 0
    SUBSCRIBED = 1


class ExporterIntent(enum.IntEnum):
    """Exporter position acks (see ValueType.EXPORTER): ACKNOWLEDGE
    commands persist an exporter's export progress in the replicated log;
    the engine folds them into ``exporter_positions`` state (snapshotted,
    bounds compaction). REMOVE drops a deconfigured exporter's entry so
    its stale position stops pinning the compaction floor."""

    ACKNOWLEDGE = 0
    ACKNOWLEDGED = 1
    REMOVE = 2


class IdIntent(enum.IntEnum):
    # Reference: protocol/.../intent/IdIntent.java (partition id generator)
    GENERATED = 0


class TimerIntent(enum.IntEnum):
    """TPU-native: explicit timer records (see ValueType.TIMER)."""

    CREATE = 0
    CREATED = 1
    TRIGGER = 2
    TRIGGERED = 3
    CANCEL = 4
    CANCELED = 5


INTENTS_BY_VALUE_TYPE = {
    ValueType.WORKFLOW_INSTANCE: WorkflowInstanceIntent,
    ValueType.JOB: JobIntent,
    ValueType.DEPLOYMENT: DeploymentIntent,
    ValueType.INCIDENT: IncidentIntent,
    ValueType.MESSAGE: MessageIntent,
    ValueType.MESSAGE_SUBSCRIPTION: MessageSubscriptionIntent,
    ValueType.WORKFLOW_INSTANCE_SUBSCRIPTION: WorkflowInstanceSubscriptionIntent,
    ValueType.TOPIC: TopicIntent,
    ValueType.SUBSCRIPTION: SubscriptionIntent,
    ValueType.SUBSCRIBER: SubscriberIntent,
    ValueType.ID: IdIntent,
    ValueType.TIMER: TimerIntent,
    ValueType.EXPORTER: ExporterIntent,
}


def intent_name(value_type: ValueType, intent: int) -> str:
    enum_cls = INTENTS_BY_VALUE_TYPE.get(ValueType(value_type))
    if enum_cls is None:
        return str(intent)
    try:
        return enum_cls(intent).name
    except ValueError:
        return str(intent)
