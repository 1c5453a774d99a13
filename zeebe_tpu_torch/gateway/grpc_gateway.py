"""gRPC gateway: the cluster's front door for polyglot clients.

Reference parity: ``gateway/.../Gateway.java`` (netty gRPC server embedded
in the broker or standalone) + the published schema
``gateway-protocol/gateway.proto`` (reference:
``gateway-protocol/src/main/proto/gateway.proto:30-33`` — the tech-preview
exposes ``Health``; this service keeps that RPC and adds the command
surface the reference serves over its SBE client protocol, typed with
protobuf messages so any language with a gRPC stack can generate a
client). Payload documents travel as msgpack bytes inside the proto
messages — record values are msgpack documents end to end, forwarded
opaquely like ``ClientApiMessageHandler`` does.
"""

from __future__ import annotations

import threading
from concurrent import futures

import grpc

from zeebe_tpu_torch.gateway.client import ClientException
from zeebe_tpu_torch.gateway.proto import gateway_pb2 as pb
from zeebe_tpu_torch.models.bpmn.xml import read_model
from zeebe_tpu_torch.protocol import msgpack

_SERVICE = "gateway_protocol.Gateway"


def _payload(msg_bytes: bytes) -> dict:
    if not msg_bytes:
        return {}
    doc = msgpack.unpack(bytes(msg_bytes))
    if not isinstance(doc, dict):
        raise ValueError("payload document must be a msgpack map")
    return doc


class GrpcGateway:
    """gRPC server bridging to a cluster (or in-process) client, speaking
    the published gateway.proto."""

    def __init__(self, client, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 16, max_streams: int = 0):
        self.client = client
        # each ActivateJobs stream occupies one executor thread for its
        # lifetime; cap streams BELOW the pool size so unary RPCs (incl.
        # the workers' own CompleteJob calls) always have threads —
        # uncapped streams livelocked the whole gateway
        self._max_streams = max_streams or max(1, max_workers // 2)
        self._active_streams = 0
        self._stream_lock = threading.Lock()
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
        rpcs = {
            "HealthCheck": (self._health_check, pb.HealthCheckRequest),
            "CreateTopic": (self._create_topic, pb.CreateTopicRequest),
            "DeployWorkflow": (self._deploy_workflow, pb.DeployWorkflowRequest),
            "CreateWorkflowInstance": (
                self._create_workflow_instance, pb.CreateWorkflowInstanceRequest
            ),
            "CancelWorkflowInstance": (
                self._cancel_workflow_instance, pb.CancelWorkflowInstanceRequest
            ),
            "PublishMessage": (self._publish_message, pb.PublishMessageRequest),
            "CompleteJob": (self._complete_job, pb.CompleteJobRequest),
            "FailJob": (self._fail_job, pb.FailJobRequest),
            "UpdateJobRetries": (self._update_job_retries, pb.UpdateJobRetriesRequest),
        }
        handlers = {
            name: grpc.unary_unary_rpc_method_handler(
                self._wrap(fn),
                request_deserializer=req_cls.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            )
            for name, (fn, req_cls) in rpcs.items()
        }
        handlers["ActivateJobs"] = grpc.unary_stream_rpc_method_handler(
            self._activate_jobs,
            request_deserializer=pb.ActivateJobsRequest.FromString,
            response_serializer=lambda m: m.SerializeToString(),
        )
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, handlers),)
        )
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self.address = (host, self.port)
        self._server.start()

    def _wrap(self, fn):
        def call(request, context: grpc.ServicerContext):
            try:
                return fn(request)
            except ClientException as e:
                context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
            except ValueError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            except Exception as e:  # noqa: BLE001
                context.abort(grpc.StatusCode.INTERNAL, str(e))

        return call

    # -- RPC implementations ------------------------------------------------
    def _health_check(self, _req) -> pb.HealthCheckResponse:
        # reference gateway.proto HealthCheck → topology (brokers/partitions)
        leaders = self.client.refresh_topology()
        return pb.HealthCheckResponse(
            brokers=[
                pb.Partition(partition_id=pid, host=addr.host, port=addr.port)
                for pid, addr in sorted(leaders.items())
            ]
        )

    def _create_topic(self, req) -> pb.CreateTopicResponse:
        record = self.client.create_topic(
            req.name,
            partitions=req.partitions or 1,
            replication_factor=req.replication_factor or 1,
        )
        return pb.CreateTopicResponse(
            name=record.value.name,
            partition_ids=list(record.value.partition_ids),
        )

    def _deploy_workflow(self, req) -> pb.DeployWorkflowResponse:
        model = read_model(bytes(req.resource))
        record = self.client.deploy_model(
            model, resource_name=req.resource_name or "process.bpmn"
        )
        return pb.DeployWorkflowResponse(
            key=record.key,
            workflows=[
                pb.WorkflowMetadata(
                    bpmn_process_id=wf.bpmn_process_id,
                    version=wf.version,
                    workflow_key=wf.key,
                )
                for wf in record.value.deployed_workflows
            ],
        )

    def _create_workflow_instance(self, req) -> pb.CreateWorkflowInstanceResponse:
        record = self.client.create_instance(
            req.bpmn_process_id,
            payload=_payload(req.payload_msgpack),
            partition_id=(
                req.partition_id
                if req.HasField("partition_id") and req.partition_id >= 0
                else None
            ),
        )
        return pb.CreateWorkflowInstanceResponse(
            workflow_instance_key=record.value.workflow_instance_key,
            bpmn_process_id=record.value.bpmn_process_id,
            version=record.value.version,
        )

    def _cancel_workflow_instance(self, req) -> pb.CancelWorkflowInstanceResponse:
        self.client.cancel_instance(req.partition_id, req.workflow_instance_key)
        return pb.CancelWorkflowInstanceResponse()

    def _publish_message(self, req) -> pb.PublishMessageResponse:
        self.client.publish_message(
            req.name,
            req.correlation_key,
            payload=_payload(req.payload_msgpack),
            time_to_live_ms=req.time_to_live_ms,
        )
        return pb.PublishMessageResponse()

    def _complete_job(self, req) -> pb.CompleteJobResponse:
        self.client.complete_job(
            req.partition_id, req.job_key, _payload(req.payload_msgpack)
        )
        return pb.CompleteJobResponse()

    def _fail_job(self, req) -> pb.FailJobResponse:
        self.client.fail_job(req.partition_id, req.job_key, req.retries)
        return pb.FailJobResponse()

    def _update_job_retries(self, req) -> pb.UpdateJobRetriesResponse:
        # retries passes through unmodified: the engine rejects
        # non-positive values (RETRIES_NOT_POSITIVE), same as the native
        # protocol — proto3 cannot distinguish unset from 0, so the proto
        # documents retries >= 1
        self.client.update_job_retries(
            req.partition_id, req.job_key, req.retries
        )
        return pb.UpdateJobRetriesResponse()

    def _activate_jobs(self, req, context: grpc.ServicerContext):
        """Server stream of activated jobs (reference: the polyglot worker
        surface — clients/go/client.go:16-38 consumes the equivalent
        subscription; later reference versions expose this exact RPC). The
        gateway holds the broker job subscription; the caller completes or
        fails each job via CompleteJob / FailJob and ends the stream by
        cancelling the call."""
        if not req.type:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "type is required")
        with self._stream_lock:
            if self._active_streams >= self._max_streams:
                context.abort(
                    grpc.StatusCode.RESOURCE_EXHAUSTED,
                    f"gateway serves at most {self._max_streams} concurrent "
                    "job streams; close one or raise max_workers",
                )
            self._active_streams += 1
        try:
            stream = self.client.open_job_stream(
                req.type,
                worker_name=req.worker or "grpc-worker",
                credits=req.max_jobs or 32,
                timeout_ms=req.timeout_ms or 300_000,
            )
        except Exception:
            # a failed subscribe (e.g. no reachable leader during failover)
            # must release the stream slot, or repeated failures exhaust
            # the gateway permanently
            with self._stream_lock:
                self._active_streams -= 1
            raise
        try:
            while context.is_active():
                item = stream.take(timeout=0.2)
                if item is None:
                    continue
                partition, record = item
                value = record.value
                headers = value.headers
                yield pb.ActivatedJob(
                    partition_id=partition,
                    key=record.key,
                    type=value.type,
                    retries=value.retries,
                    deadline=value.deadline,
                    worker=value.worker,
                    payload_msgpack=msgpack.pack(dict(value.payload or {})),
                    bpmn_process_id=headers.bpmn_process_id,
                    activity_id=headers.activity_id,
                    workflow_instance_key=headers.workflow_instance_key,
                    activity_instance_key=headers.activity_instance_key,
                )
        finally:
            stream.close()
            with self._stream_lock:
                self._active_streams -= 1

    def close(self) -> None:
        self._server.stop(grace=1)


class GrpcGatewayClient:
    """Typed client over the published proto (reference
    ``clients/go/client.go``: gRPC dial + HealthCheck; any language with a
    gRPC stack generates the same surface from gateway-protocol/gateway.proto)."""

    _REQUESTS = {
        "HealthCheck": (pb.HealthCheckRequest, pb.HealthCheckResponse),
        "CreateTopic": (pb.CreateTopicRequest, pb.CreateTopicResponse),
        "DeployWorkflow": (pb.DeployWorkflowRequest, pb.DeployWorkflowResponse),
        "CreateWorkflowInstance": (
            pb.CreateWorkflowInstanceRequest, pb.CreateWorkflowInstanceResponse
        ),
        "CancelWorkflowInstance": (
            pb.CancelWorkflowInstanceRequest, pb.CancelWorkflowInstanceResponse
        ),
        "PublishMessage": (pb.PublishMessageRequest, pb.PublishMessageResponse),
        "CompleteJob": (pb.CompleteJobRequest, pb.CompleteJobResponse),
        "FailJob": (pb.FailJobRequest, pb.FailJobResponse),
        "UpdateJobRetries": (pb.UpdateJobRetriesRequest, pb.UpdateJobRetriesResponse),
    }

    def __init__(self, host: str, port: int):
        self._channel = grpc.insecure_channel(f"{host}:{port}")
        self._calls = {}

    def call(self, method: str, request=None, timeout: float = 15.0):
        req_cls, rsp_cls = self._REQUESTS[method]
        rpc = self._calls.get(method)
        if rpc is None:
            rpc = self._channel.unary_unary(
                f"/{_SERVICE}/{method}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=rsp_cls.FromString,
            )
            self._calls[method] = rpc
        return rpc(request if request is not None else req_cls(), timeout=timeout)

    def health_check(self) -> "pb.HealthCheckResponse":
        return self.call("HealthCheck")

    def activate_jobs(self, request: "pb.ActivateJobsRequest"):
        """Server-streaming ActivateJobs: an iterator of ActivatedJob (the
        polyglot worker surface; cancel the returned call to release the
        gateway-held subscription)."""
        rpc = self._calls.get("ActivateJobs")
        if rpc is None:
            rpc = self._channel.unary_stream(
                f"/{_SERVICE}/ActivateJobs",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=pb.ActivatedJob.FromString,
            )
            self._calls["ActivateJobs"] = rpc
        return rpc(request)

    def close(self) -> None:
        self._channel.close()
