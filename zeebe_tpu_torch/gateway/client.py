"""Client API.

Reference parity: ``gateway/.../ZeebeClient.java`` and the fluent command
API (``WorkflowClient``: deploy / create instance / cancel / update payload;
``JobClient``: create / complete / fail / update retries; ``TopicClient``:
publish message, topic subscriptions). This is the in-process client bound
directly to a Broker; the TCP/gRPC gateway wraps the same calls.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from zeebe_tpu_torch.models.bpmn.model import BpmnModel
from zeebe_tpu_torch.models.bpmn.xml import write_model
from zeebe_tpu_torch.protocol.enums import RecordType
from zeebe_tpu_torch.protocol.intents import (
    DeploymentIntent,
    JobIntent,
    MessageIntent,
    WorkflowInstanceIntent,
)
from zeebe_tpu_torch.protocol.records import (
    DeploymentRecord,
    DeploymentResource,
    JobRecord,
    MessageRecord,
    Record,
    WorkflowInstanceRecord,
)
from zeebe_tpu_torch.runtime.broker import Broker


class ClientException(RuntimeError):
    """Raised for command rejections (reference ClientCommandRejectedException)."""

    def __init__(self, rejection_type, reason: str):
        try:
            from zeebe_tpu_torch.protocol.enums import RejectionType

            type_name = RejectionType(rejection_type).name
        except ValueError:
            type_name = str(rejection_type)
        super().__init__(f"Command rejected ({type_name}): {reason}")
        self.rejection_type = rejection_type
        self.reason = reason


@dataclasses.dataclass
class WorkflowInstanceResult:
    workflow_instance_key: int
    workflow_key: int
    bpmn_process_id: str
    version: int
    record: Record


def _workflow_meta(wf) -> dict:
    return {
        "bpmn_process_id": wf.id,
        "version": wf.version,
        "workflow_key": wf.key,
        "resource_name": getattr(wf, "resource_name", "") or "",
    }


class _RepositoryQueries:
    """Workflow repository queries (reference WorkflowRepositoryService
    control messages: list-workflows / get-workflow with the deployed
    resource; ``gateway/.../api/commands/WorkflowRequest``)."""

    def _repository(self):
        raise NotImplementedError

    def list_workflows(self, bpmn_process_id: Optional[str] = None) -> List[dict]:
        repo = self._repository()
        if bpmn_process_id:
            workflows = list(repo.versions.get(bpmn_process_id, []))
        else:
            workflows = list(repo.by_key.values())
        return [_workflow_meta(wf) for wf in sorted(workflows, key=lambda w: w.key)]

    def get_workflow(
        self,
        workflow_key: int = -1,
        bpmn_process_id: str = "",
        version: int = -1,
    ) -> dict:
        """Fetch one workflow incl. its deployed resource. ``version=-1``
        means latest."""
        repo = self._repository()
        wf = None
        if workflow_key >= 0:
            wf = repo.by_key.get(workflow_key)
        elif bpmn_process_id and version >= 0:
            wf = repo.by_id_and_version(bpmn_process_id, version)
        elif bpmn_process_id:
            wf = repo.latest(bpmn_process_id)
        if wf is None:
            raise ClientException(
                0, f"no workflow for key={workflow_key} id={bpmn_process_id!r} "
                   f"version={version}"
            )
        meta = _workflow_meta(wf)
        meta["resource"] = wf.source_resource
        meta["resource_type"] = wf.source_type
        return meta



class ZeebeClient(_RepositoryQueries):
    """In-process client (reference embedded-gateway mode)."""

    def __init__(self, broker: Broker):
        self.broker = broker

    def _repository(self):
        return self.broker.repository

    # -- helpers -----------------------------------------------------------
    def _await(self, request_id: Optional[int]) -> Record:
        self.broker.run_until_idle()
        response = self.broker.take_response(request_id)
        if response is None:
            raise RuntimeError("no response received")
        if response.metadata.record_type == RecordType.COMMAND_REJECTION:
            raise ClientException(
                response.metadata.rejection_type, response.metadata.rejection_reason
            )
        return response

    # -- workflow commands (reference WorkflowClient) ----------------------
    def deploy_model(self, model: BpmnModel, resource_name: str = "process.bpmn") -> Record:
        return self.deploy_resources(
            [DeploymentResource(resource=write_model(model), resource_name=resource_name)]
        )

    def deploy_yaml(self, yaml_text: str, resource_name: str = "workflow.yaml") -> Record:
        return self.deploy_resources(
            [
                DeploymentResource(
                    resource=yaml_text.encode("utf-8"),
                    resource_type="YAML_WORKFLOW",
                    resource_name=resource_name,
                )
            ]
        )

    def deploy_resources(self, resources: List[DeploymentResource]) -> Record:
        # deployments run on the system partition (reference: DeploymentManager
        # on partition 0; other partitions fetch from the shared repository)
        deployment = DeploymentRecord(resources=resources)
        request_id = self.broker.write_command(0, deployment, DeploymentIntent.CREATE)
        return self._await(request_id)

    def create_instance(
        self,
        bpmn_process_id: str = "",
        payload: Optional[Dict[str, Any]] = None,
        version: int = -1,
        workflow_key: int = -1,
        partition_id: Optional[int] = None,
    ) -> WorkflowInstanceResult:
        value = WorkflowInstanceRecord(
            bpmn_process_id=bpmn_process_id,
            version=version,
            workflow_key=workflow_key,
            payload=dict(payload or {}),
        )
        pid = partition_id if partition_id is not None else self.broker.next_partition()
        request_id = self.broker.write_command(pid, value, WorkflowInstanceIntent.CREATE)
        response = self._await(request_id)
        return WorkflowInstanceResult(
            workflow_instance_key=response.key,
            workflow_key=response.value.workflow_key,
            bpmn_process_id=response.value.bpmn_process_id,
            version=response.value.version,
            record=response,
        )

    def cancel_instance(self, workflow_instance_key: int, partition_id: int = 0) -> Record:
        value = WorkflowInstanceRecord(workflow_instance_key=workflow_instance_key)
        request_id = self.broker.write_command(
            partition_id, value, WorkflowInstanceIntent.CANCEL, key=workflow_instance_key
        )
        return self._await(request_id)

    def update_payload(
        self,
        workflow_instance_key: int,
        payload: Dict[str, Any],
        partition_id: int = 0,
        activity_instance_key: Optional[int] = None,
    ) -> Record:
        """Update the instance payload. For incident resolution, pass the
        failed token's key as ``activity_instance_key`` (the reference client
        builds the command from the activity instance event, so the command
        key is the activity instance key)."""
        value = WorkflowInstanceRecord(
            workflow_instance_key=workflow_instance_key, payload=dict(payload)
        )
        request_id = self.broker.write_command(
            partition_id, value, WorkflowInstanceIntent.UPDATE_PAYLOAD,
            key=activity_instance_key if activity_instance_key is not None
            else workflow_instance_key,
        )
        return self._await(request_id)

    # -- job commands (reference JobClient) --------------------------------
    def create_job(self, job_type: str, payload: Optional[dict] = None,
                   retries: int = 3, partition_id: int = 0) -> Record:
        value = JobRecord(type=job_type, retries=retries, payload=dict(payload or {}))
        request_id = self.broker.write_command(partition_id, value, JobIntent.CREATE)
        return self._await(request_id)

    def complete_job(self, job_key: int, payload: Optional[dict] = None,
                     partition_id: int = 0) -> Record:
        value = JobRecord(payload=dict(payload or {}))
        request_id = self.broker.write_command(
            partition_id, value, JobIntent.COMPLETE, key=job_key
        )
        return self._await(request_id)

    def fail_job(self, job_key: int, retries: int, partition_id: int = 0,
                 job_record: Optional[JobRecord] = None) -> Record:
        value = job_record.copy() if job_record is not None else JobRecord()
        value.retries = retries
        request_id = self.broker.write_command(
            partition_id, value, JobIntent.FAIL, key=job_key
        )
        return self._await(request_id)

    def update_job_retries(self, job_key: int, retries: int, partition_id: int = 0) -> Record:
        value = JobRecord(retries=retries)
        request_id = self.broker.write_command(
            partition_id, value, JobIntent.UPDATE_RETRIES, key=job_key
        )
        return self._await(request_id)

    # -- messages (reference TopicClient.newPublishMessageCommand) ---------
    def publish_message(
        self,
        name: str,
        correlation_key: str,
        payload: Optional[Dict[str, Any]] = None,
        time_to_live_ms: int = 0,
        message_id: str = "",
    ) -> Record:
        value = MessageRecord(
            name=name,
            correlation_key=correlation_key,
            time_to_live=time_to_live_ms,
            payload=dict(payload or {}),
            message_id=message_id,
        )
        pid = self.broker.partition_for_correlation_key(correlation_key)
        request_id = self.broker.write_command(pid, value, MessageIntent.PUBLISH)
        return self._await(request_id)

    # -- incidents ---------------------------------------------------------
    def resolve_incident(
        self, incident_key: int, payload: Dict[str, Any], partition_id: int = 0
    ) -> None:
        from zeebe_tpu_torch.protocol.intents import IncidentIntent
        from zeebe_tpu_torch.protocol.records import IncidentRecord

        value = IncidentRecord(payload=dict(payload))
        self.broker.write_command(
            partition_id, value, IncidentIntent.RESOLVE, key=incident_key,
            with_response=False,
        )
        self.broker.run_until_idle()


class TopicSubscriber:
    """Managed topic subscription (reference ``gateway/.../impl/subscription``
    ``SubscriberGroup`` with credit acking): receives every committed record
    of a partition, auto-acknowledges in batches, resumes from the persisted
    ack position after reopen/restart."""

    def __init__(
        self,
        broker,
        name: str,
        handler=None,
        partition_id: int = 0,
        start_position=None,
        credits: int = 32,
        force_start: bool = False,
        ack_batch: int = 0,
    ):
        self.records = []
        self._user_handler = handler
        self._ack_batch = ack_batch or max(credits // 2, 1)
        self._since_ack = 0
        # pushes can arrive while open_topic_subscription is still running
        # (the broker pumps synchronously); auto-acks wait for the handle
        self.handle = None
        self.handle = broker.open_topic_subscription(
            name,
            self._on_record,
            partition_id=partition_id,
            start_position=start_position,
            credits=credits,
            force_start=force_start,
        )

    def _on_record(self, partition_id: int, record) -> None:
        self.records.append(record)
        if self._user_handler is not None:
            self._user_handler(partition_id, record)
        self._since_ack += 1
        if self.handle is not None and self._since_ack >= self._ack_batch:
            self.handle.ack(record.position)
            self._since_ack = 0

    def ack_all(self) -> None:
        if self.records:
            self.handle.ack(self.records[-1].position)
            self._since_ack = 0

    def close(self) -> None:
        self.handle.close()
