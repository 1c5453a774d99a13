"""Job workers with credit-based push.

Reference parity: ``gateway/.../impl/subscription/job/JobSubscriber.java``
(push with credits, poll loop, auto-completion) and the broker-side
``ActivateJobStreamProcessor`` + ``IncreaseJobSubscriptionCreditsHandler``.
"""

from __future__ import annotations

import itertools
from typing import Callable, List, Optional

from zeebe_tpu_torch.engine.interpreter import JobSubscription
from zeebe_tpu_torch.protocol.records import JobRecord, Record
from zeebe_tpu_torch.runtime.broker import Broker

_subscriber_keys = itertools.count(1)


class JobWorker:
    """A worker subscription: receives ACTIVATED pushes, invokes the handler,
    completes or fails the job, and replenishes credits."""

    def __init__(
        self,
        broker: Broker,
        job_type: str,
        handler: Callable[["JobContext"], Optional[dict]],
        *,
        worker_name: str = "default-worker",
        credits: int = 32,
        timeout_ms: int = 300_000,
        auto_complete: bool = True,
    ):
        self.broker = broker
        self.job_type = job_type
        self.handler = handler
        self.worker_name = worker_name
        self.auto_complete = auto_complete
        self.subscriber_key = next(_subscriber_keys)
        self.initial_credits = credits
        self.handled: List[Record] = []

        broker.on_push(self.subscriber_key, self._on_push)
        for partition in broker.partitions:
            backlog = partition.engine.add_job_subscription(
                JobSubscription(
                    subscriber_key=self.subscriber_key,
                    job_type=job_type,
                    worker=worker_name,
                    timeout=timeout_ms,
                    credits=credits,
                )
            )
            # jobs created before this worker subscribed (e.g. after a broker
            # restart) are assigned immediately via ACTIVATE commands
            if backlog:
                partition.log.append(backlog)

    def _on_push(self, partition_id: int, record: Record) -> None:
        self.handled.append(record)
        context = JobContext(self, record, partition_id)
        result = self.handler(context)
        if self.auto_complete and not context.finished:
            context.complete(result if isinstance(result, dict) else None)
        # replenish one credit on the partition that consumed it (reference
        # JobSubscriber credit replenishment via control message), then
        # assign backlog jobs that were waiting for a credit
        engine = self.broker.partitions[partition_id].engine
        engine.increase_job_credits(self.subscriber_key, 1)
        backlog = engine.backlog_activations()
        if backlog:
            self.broker.partitions[partition_id].log.append(backlog)

    def close(self) -> None:
        for partition in self.broker.partitions:
            partition.engine.remove_job_subscription(self.subscriber_key)


class JobContext:
    """Handed to job handlers (reference JobClient in JobHandler.handle)."""

    def __init__(self, worker: JobWorker, record: Record, partition_id: int = 0):
        self.worker = worker
        self.record = record
        self.partition_id = partition_id
        self.finished = False

    @property
    def key(self) -> int:
        return self.record.key

    @property
    def job(self) -> JobRecord:
        return self.record.value

    @property
    def payload(self) -> dict:
        return self.record.value.payload

    def complete(self, payload: Optional[dict] = None) -> None:
        from zeebe_tpu_torch.protocol.intents import JobIntent

        value = JobRecord(
            payload=dict(payload) if payload is not None else dict(self.payload),
            headers=self.job.headers,
            type=self.job.type,
        )
        self.worker.broker.write_command(
            self.partition_id, value, JobIntent.COMPLETE, key=self.key,
            with_response=False,
        )
        self.finished = True

    def fail(self, retries: int) -> None:
        from zeebe_tpu_torch.protocol.intents import JobIntent

        value = self.job.copy()
        value.retries = retries
        self.worker.broker.write_command(
            self.partition_id, value, JobIntent.FAIL, key=self.key,
            with_response=False,
        )
        self.finished = True
