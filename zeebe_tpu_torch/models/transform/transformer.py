"""BPMN model → executable workflow transform.

Reference parity: ``broker-core/.../workflow/model/transformation/``:
``BpmnTransformer`` walks the model and the 12 handlers bind the
per-(element, lifecycle-intent) step table:

- ProcessHandler: READY→APPLY_INPUT_MAPPING, ACTIVATED→TRIGGER_START_EVENT,
  COMPLETING→COMPLETE_PROCESS, TERMINATING→TERMINATE_CONTAINED_INSTANCES.
- ActivityHandler: READY→APPLY_INPUT_MAPPING, COMPLETING→APPLY_OUTPUT_MAPPING,
  COMPLETED→outgoing step, TERMINATED→PROPAGATE_TERMINATION.
- ServiceTaskHandler: ACTIVATED→CREATE_JOB, TERMINATING→TERMINATE_JOB_TASK.
- StartEventHandler: START_EVENT_OCCURRED→outgoing step.
- EndEventHandler: END_EVENT_OCCURRED→outgoing step.
- ExclusiveGatewayHandler: GATEWAY_ACTIVATED→EXCLUSIVE_SPLIT (with
  conditions) else outgoing step; default flow.
- SequenceFlowHandler: SEQUENCE_FLOW_TAKEN→START_STATEFUL_ELEMENT |
  ACTIVATE_GATEWAY | TRIGGER_END_EVENT by target kind; condition compiled.
- FlowNodeHandler: outgoing step = TAKE_SEQUENCE_FLOW if outgoing else
  CONSUME_TOKEN; io mappings.
- SubProcessHandler / IntermediateCatchEventHandler analogously.

TPU-native extensions: parallel gateways (PARALLEL_SPLIT/PARALLEL_MERGE),
timer catch events (CREATE_TIMER), receive tasks.
"""

from __future__ import annotations

from typing import List

from zeebe_tpu_torch.models.bpmn.model import (
    BoundaryEvent,
    BpmnModel,
    ElementType,
    EndEvent,
    ExclusiveGateway,
    FlowNode,
    IntermediateCatchEvent,
    ParallelGateway,
    Process,
    ReceiveTask,
    SequenceFlow,
    ServiceTask,
    StartEvent,
    SubProcess,
)
from zeebe_tpu_torch.models.el.parser import parse_condition
from zeebe_tpu_torch.models.transform.executable import (
    ExecutableFlowElement,
    ExecutableWorkflow,
)
from zeebe_tpu_torch.models.transform.steps import BpmnStep
from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent as WI


def transform_model(model: BpmnModel) -> List[ExecutableWorkflow]:
    """Transform every executable process in the model."""
    return [
        _transform_process(model, process)
        for process in model.processes
        if process.executable
    ]


def _transform_process(model: BpmnModel, process: Process) -> ExecutableWorkflow:
    workflow = ExecutableWorkflow(id=process.id)

    # element table: process (root scope) first, then nodes, then flows —
    # dense indices feed the device element table directly.
    root = ExecutableFlowElement(
        id=process.id, index=0, element_type=ElementType.PROCESS
    )
    workflow.add(root)

    scope_ids = {process.id}
    pending = [process.id]
    nodes: List[FlowNode] = []
    flows: List[SequenceFlow] = []
    while pending:
        scope = pending.pop(0)
        for node in model.nodes_in_scope(scope):
            nodes.append(node)
            if isinstance(node, SubProcess):
                scope_ids.add(node.id)
                pending.append(node.id)
        flows.extend(model.flows_in_scope(scope))

    for node in nodes:
        el = ExecutableFlowElement(
            id=node.id,
            index=len(workflow.elements),
            element_type=node.element_type,
            scope_id=node.scope_id,
            input_mappings=list(node.input_mappings),
            output_mappings=list(node.output_mappings),
            output_behavior=node.output_behavior,
        )
        if isinstance(node, ServiceTask):
            el.job_type = node.task_definition.type
            el.job_retries = node.task_definition.retries
            el.job_headers = dict(node.task_headers)
        if isinstance(node, (IntermediateCatchEvent, ReceiveTask)):
            if node.message is not None:
                el.message_name = node.message.name
                el.correlation_key_path = node.message.correlation_key
            if isinstance(node, IntermediateCatchEvent):
                el.timer_duration_ms = node.timer_duration_ms
        if isinstance(node, BoundaryEvent):
            el.cancel_activity = node.cancel_activity
            el.timer_duration_ms = node.timer_duration_ms
            if node.message is not None:
                el.message_name = node.message.name
                el.correlation_key_path = node.message.correlation_key
        if isinstance(node, SubProcess) and node.multi_instance is not None:
            mi = node.multi_instance
            el.is_multi_instance = True
            el.mi_input_collection = mi.input_collection
            el.mi_input_element = mi.input_element or "item"
            el.mi_cardinality = mi.cardinality
            el.mi_output_collection = mi.output_collection
            el.mi_output_element = (
                mi.output_element or f"$.{el.mi_input_element}"
            )
        workflow.add(el)

    for flow in flows:
        el = ExecutableFlowElement(
            id=flow.id,
            index=len(workflow.elements),
            element_type=ElementType.SEQUENCE_FLOW,
            scope_id=flow.scope_id,
            condition_text=flow.condition_expression,
        )
        if flow.condition_expression:
            el.condition = parse_condition(flow.condition_expression)
        workflow.add(el)

    # connect (reference SequenceFlowHandler.connectWithFlowNodes)
    for flow in flows:
        flow_el = workflow.by_id[flow.id]
        source_el = workflow.by_id[flow.source_id]
        target_el = workflow.by_id[flow.target_id]
        source_el.outgoing.append(flow_el)
        target_el.incoming.append(flow_el)
        flow_el.source = source_el
        flow_el.target = target_el

    # bind lifecycle steps
    _bind_process(root)
    for node in nodes:
        el = workflow.by_id[node.id]
        outgoing_step = (
            BpmnStep.TAKE_SEQUENCE_FLOW if el.outgoing else BpmnStep.CONSUME_TOKEN
        )
        if isinstance(node, StartEvent):
            el.bind(WI.START_EVENT_OCCURRED, outgoing_step)
            scope_el = workflow.by_id[node.scope_id]
            scope_el.start_event = el
        elif isinstance(node, EndEvent):
            el.bind(WI.END_EVENT_OCCURRED, outgoing_step)
        elif isinstance(node, ServiceTask):
            _bind_activity(el, outgoing_step)
            el.bind(WI.ELEMENT_ACTIVATED, BpmnStep.CREATE_JOB)
            el.bind(WI.ELEMENT_TERMINATING, BpmnStep.TERMINATE_JOB_TASK)
        elif isinstance(node, ExclusiveGateway):
            has_conditions = any(
                f.condition is not None for f in el.outgoing
            )
            el.bind(
                WI.GATEWAY_ACTIVATED,
                BpmnStep.EXCLUSIVE_SPLIT if has_conditions else outgoing_step,
            )
            if node.default_flow_id is not None:
                el.default_flow = workflow.by_id[node.default_flow_id]
        elif isinstance(node, ParallelGateway):
            el.bind(
                WI.GATEWAY_ACTIVATED,
                BpmnStep.PARALLEL_SPLIT if len(el.outgoing) > 1 else outgoing_step,
            )
        elif isinstance(node, (IntermediateCatchEvent, ReceiveTask)):
            _bind_activity(el, outgoing_step)
            if el.message_name:
                el.bind(WI.ELEMENT_ACTIVATED, BpmnStep.SUBSCRIBE_TO_INTERMEDIATE_MESSAGE)
                el.bind(WI.ELEMENT_TERMINATING, BpmnStep.TERMINATE_CATCH_EVENT)
            elif el.timer_duration_ms is not None:
                el.bind(WI.ELEMENT_ACTIVATED, BpmnStep.CREATE_TIMER)
                el.bind(WI.ELEMENT_TERMINATING, BpmnStep.TERMINATE_CATCH_EVENT)
            else:
                el.bind(WI.ELEMENT_TERMINATING, BpmnStep.TERMINATE_ELEMENT)
        elif isinstance(node, SubProcess):
            _bind_activity(el, outgoing_step)
            el.bind(
                WI.ELEMENT_ACTIVATED,
                BpmnStep.MULTI_INSTANCE_SPLIT
                if el.is_multi_instance
                else BpmnStep.TRIGGER_START_EVENT,
            )
            el.bind(WI.ELEMENT_TERMINATING, BpmnStep.TERMINATE_CONTAINED_INSTANCES)
        elif isinstance(node, BoundaryEvent):
            # the boundary event itself only carries the continuation: the
            # token appears at it via BOUNDARY_EVENT_OCCURRED after the
            # trigger (and, when interrupting, the host's termination)
            el.bind(WI.BOUNDARY_EVENT_OCCURRED, outgoing_step)
            host = workflow.by_id[node.attached_to_id]
            el.attached_to = host
            host.boundary_events.append(el)

    # sequence flow steps (reference SequenceFlowHandler.bindLifecycle,
    # extended with parallel-gateway targets)
    for flow in flows:
        flow_el = workflow.by_id[flow.id]
        target = flow_el.target
        if target.element_type in (
            ElementType.SERVICE_TASK,
            ElementType.INTERMEDIATE_CATCH_EVENT,
            ElementType.RECEIVE_TASK,
            ElementType.SUB_PROCESS,
        ):
            step = BpmnStep.START_STATEFUL_ELEMENT
        elif target.element_type == ElementType.EXCLUSIVE_GATEWAY:
            step = BpmnStep.ACTIVATE_GATEWAY
        elif target.element_type == ElementType.PARALLEL_GATEWAY:
            step = (
                BpmnStep.PARALLEL_MERGE
                if len(target.incoming) > 1
                else BpmnStep.ACTIVATE_GATEWAY
            )
        elif target.element_type == ElementType.END_EVENT:
            step = BpmnStep.TRIGGER_END_EVENT
        else:
            raise ValueError(
                f"Unsupported sequence flow target: {target.id} ({target.element_type.name})"
            )
        flow_el.bind(WI.SEQUENCE_FLOW_TAKEN, step)

    return workflow


def _bind_process(root: ExecutableFlowElement) -> None:
    # Reference: ProcessHandler.transform
    root.bind(WI.ELEMENT_READY, BpmnStep.APPLY_INPUT_MAPPING)
    root.bind(WI.ELEMENT_ACTIVATED, BpmnStep.TRIGGER_START_EVENT)
    root.bind(WI.ELEMENT_COMPLETING, BpmnStep.COMPLETE_PROCESS)
    root.bind(WI.ELEMENT_TERMINATING, BpmnStep.TERMINATE_CONTAINED_INSTANCES)


def _bind_activity(el: ExecutableFlowElement, outgoing_step: BpmnStep) -> None:
    # Reference: ActivityHandler.bindLifecycle
    el.bind(WI.ELEMENT_READY, BpmnStep.APPLY_INPUT_MAPPING)
    el.bind(WI.ELEMENT_COMPLETING, BpmnStep.APPLY_OUTPUT_MAPPING)
    el.bind(WI.ELEMENT_COMPLETED, outgoing_step)
    el.bind(WI.ELEMENT_TERMINATED, BpmnStep.PROPAGATE_TERMINATION)
