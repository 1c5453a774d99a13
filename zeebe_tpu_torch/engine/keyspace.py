"""Per-partition key generation.

Reference parity: ``broker-core/.../logstreams/processor/KeyGenerator.java``
— strided counters so entity families get disjoint keys on one partition:
workflow keys ≡ 1 (mod 5), job ≡ 2, incident ≡ 3, deployment ≡ 4, topic ≡ 0.
"""

from __future__ import annotations

STEP_SIZE = 5
WF_OFFSET = 1
JOB_OFFSET = 2
INCIDENT_OFFSET = 3
DEPLOYMENT_OFFSET = 4
TOPIC_OFFSET = 5


class KeyGenerator:
    def __init__(self, initial_value: int, step_size: int = STEP_SIZE):
        self._next = initial_value
        self._step = step_size

    def next_key(self) -> int:
        key = self._next
        self._next += self._step
        return key

    def set_key(self, key: int) -> None:
        """Resume after ``key`` (recovery: reference stateController.recoverLatestJobKey)."""
        if key + self._step > self._next:
            self._next = key + self._step

    @property
    def peek(self) -> int:
        return self._next


def workflow_instance_keys() -> KeyGenerator:
    return KeyGenerator(WF_OFFSET)


def job_keys() -> KeyGenerator:
    return KeyGenerator(JOB_OFFSET)


def incident_keys() -> KeyGenerator:
    return KeyGenerator(INCIDENT_OFFSET)


def deployment_keys() -> KeyGenerator:
    return KeyGenerator(DEPLOYMENT_OFFSET)


def topic_keys() -> KeyGenerator:
    return KeyGenerator(TOPIC_OFFSET)


def topic_subscriber_keys() -> KeyGenerator:
    """Reference: TopicSubscriptionManagementProcessor's own key space —
    per-processor generators may overlap numerically across entity families
    (keys are unique per (partition, processor), KeyGenerator.java:23)."""
    return KeyGenerator(TOPIC_OFFSET)
