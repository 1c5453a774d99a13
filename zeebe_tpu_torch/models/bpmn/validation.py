"""Deploy-time model validation.

Reference parity: ``bpmn-model/.../validation/`` + broker-side
``BpmnValidator`` / ``ZeebeExpressionValidator``
(broker-core/.../workflow/model/validation/): structural checks and
condition-expression compilation errors surfaced as deployment rejections.
"""

from __future__ import annotations

import dataclasses
from typing import List

from zeebe_tpu_torch.models.bpmn.model import (
    BoundaryEvent,
    BpmnModel,
    ExclusiveGateway,
    FlowNode,
    IntermediateCatchEvent,
    ReceiveTask,
    SequenceFlow,
    ServiceTask,
    StartEvent,
    SubProcess,
)
from zeebe_tpu_torch.models.el.parser import ConditionParseError, parse_condition
from zeebe_tpu_torch.protocol.jsonpath import JsonPathError, compile_query


@dataclasses.dataclass
class ValidationError:
    element_id: str
    message: str

    def __str__(self):
        return f"{self.element_id}: {self.message}"


def validate_model(model: BpmnModel) -> List[ValidationError]:
    errors: List[ValidationError] = []

    for process in model.processes:
        if not process.executable:
            continue
        starts = [
            n
            for n in model.nodes_in_scope(process.id)
            if isinstance(n, StartEvent)
        ]
        if len(starts) != 1:
            errors.append(
                ValidationError(process.id, "process must have exactly one start event")
            )

    def check_path(element_id: str, path: str, what: str) -> None:
        if not path:
            return
        try:
            compile_query(path)
        except JsonPathError as e:
            errors.append(ValidationError(element_id, f"{what}: {e}"))

    for element in model.elements.values():
        if isinstance(element, FlowNode):
            for m in element.input_mappings:
                check_path(element.id, m.source, "input mapping source")
                check_path(element.id, m.target, "input mapping target")
            for m in element.output_mappings:
                check_path(element.id, m.source, "output mapping source")
                check_path(element.id, m.target, "output mapping target")
        msg = getattr(element, "message", None)
        if msg is not None and msg.correlation_key:
            check_path(element.id, msg.correlation_key, "correlation key")
        if isinstance(element, ServiceTask):
            if not element.task_definition.type:
                errors.append(
                    ValidationError(element.id, "service task must have a task type")
                )
            if element.task_definition.retries < 0:
                errors.append(
                    ValidationError(element.id, "task retries must be >= 0")
                )
        elif isinstance(element, SubProcess):
            starts = [
                n
                for n in model.nodes_in_scope(element.id)
                if isinstance(n, StartEvent)
            ]
            if len(starts) != 1:
                errors.append(
                    ValidationError(
                        element.id, "sub-process must have exactly one start event"
                    )
                )
            mi = element.multi_instance
            if mi is not None:
                if not mi.input_collection and not (
                    mi.cardinality is not None and mi.cardinality > 0
                ):
                    errors.append(
                        ValidationError(
                            element.id,
                            "multi-instance activity must have an input collection "
                            "or a positive cardinality",
                        )
                    )
                # input_collection and output_element are JSONPath queries
                # (evaluated in the engine hot loop — a malformed one must
                # reject at deploy, round-3 advisor); input_element and
                # output_collection are plain variable names
                if mi.input_collection:
                    check_path(element.id, mi.input_collection, "input collection")
                if getattr(mi, "output_element", None):
                    check_path(element.id, mi.output_element, "output element")
        elif isinstance(element, ExclusiveGateway):
            for flow in element.outgoing:
                if (
                    len(element.outgoing) > 1
                    and flow.condition_expression is None
                    and flow.id != element.default_flow_id
                ):
                    errors.append(
                        ValidationError(
                            flow.id,
                            "sequence flow out of a splitting exclusive gateway "
                            "must have a condition or be the default flow",
                        )
                    )
        elif isinstance(element, (IntermediateCatchEvent, ReceiveTask)):
            msg = element.message
            timer = getattr(element, "timer_duration_ms", None)
            if msg is None and timer is None:
                errors.append(
                    ValidationError(
                        element.id, "catch event must have a message or timer definition"
                    )
                )
            elif msg is not None and not msg.correlation_key:
                errors.append(
                    ValidationError(
                        element.id, "message subscription must have a correlation key"
                    )
                )
        elif isinstance(element, BoundaryEvent):
            host = model.elements.get(element.attached_to_id)
            if not isinstance(host, (ServiceTask, SubProcess, ReceiveTask)):
                errors.append(
                    ValidationError(
                        element.id,
                        "boundary event must be attached to a service task, "
                        "receive task or sub-process",
                    )
                )
            has_timer = element.timer_duration_ms is not None
            has_msg = element.message is not None
            if has_timer == has_msg:
                errors.append(
                    ValidationError(
                        element.id,
                        "boundary event must have exactly one of a timer or "
                        "message definition",
                    )
                )
            elif has_msg and not element.message.correlation_key:
                errors.append(
                    ValidationError(
                        element.id, "message subscription must have a correlation key"
                    )
                )
        elif isinstance(element, SequenceFlow):
            if element.condition_expression is not None:
                try:
                    parse_condition(element.condition_expression)
                except ConditionParseError as e:
                    errors.append(ValidationError(element.id, str(e)))

        if isinstance(element, FlowNode) and not isinstance(
            element, (StartEvent, BoundaryEvent)
        ):
            # boundary events have no incoming flow: the token arrives via
            # the trigger, not a sequence flow
            if not element.incoming and element.scope_id:
                errors.append(
                    ValidationError(element.id, "flow node has no incoming sequence flow")
                )

    return errors
