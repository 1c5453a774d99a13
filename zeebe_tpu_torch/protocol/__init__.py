"""Record protocol: intents, enums, record values, codecs.

Reference parity: ``protocol/src/main/resources/protocol.xml`` (SBE schema),
``protocol/src/main/java/io/zeebe/protocol/intent/*.java``.
"""

from zeebe_tpu_torch.protocol.enums import (
    RecordType,
    RejectionType,
    ValueType,
    ErrorType,
    SubscriptionType,
    ControlMessageType,
)
from zeebe_tpu_torch.protocol.intents import (
    Intent,
    DeploymentIntent,
    IncidentIntent,
    JobIntent,
    MessageIntent,
    MessageSubscriptionIntent,
    TimerIntent,
    TopicIntent,
    WorkflowInstanceIntent,
    WorkflowInstanceSubscriptionIntent,
    INTENTS_BY_VALUE_TYPE,
)
from zeebe_tpu_torch.protocol.metadata import RecordMetadata
from zeebe_tpu_torch.protocol.records import (
    Record,
    DeploymentRecord,
    IncidentRecord,
    JobRecord,
    MessageRecord,
    MessageSubscriptionRecord,
    TimerRecord,
    TopicRecord,
    WorkflowInstanceRecord,
    WorkflowInstanceSubscriptionRecord,
    VALUE_CLASS_BY_TYPE,
)

SYSTEM_TOPIC = "internal-system"
SYSTEM_PARTITION = 0
DEPLOYMENT_PARTITION = 0

__all__ = [
    "RecordType",
    "RejectionType",
    "ValueType",
    "ErrorType",
    "SubscriptionType",
    "ControlMessageType",
    "Intent",
    "DeploymentIntent",
    "IncidentIntent",
    "JobIntent",
    "MessageIntent",
    "MessageSubscriptionIntent",
    "TimerIntent",
    "TopicIntent",
    "WorkflowInstanceIntent",
    "WorkflowInstanceSubscriptionIntent",
    "INTENTS_BY_VALUE_TYPE",
    "RecordMetadata",
    "Record",
    "DeploymentRecord",
    "IncidentRecord",
    "JobRecord",
    "MessageRecord",
    "MessageSubscriptionRecord",
    "TimerRecord",
    "TopicRecord",
    "WorkflowInstanceRecord",
    "WorkflowInstanceSubscriptionRecord",
    "VALUE_CLASS_BY_TYPE",
    "SYSTEM_TOPIC",
    "SYSTEM_PARTITION",
    "DEPLOYMENT_PARTITION",
]
