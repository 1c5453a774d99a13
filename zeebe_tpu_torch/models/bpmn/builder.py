"""Fluent BPMN builder.

Reference parity: ``bpmn-model/.../Bpmn.createProcess`` (Bpmn.java:331) and
the 60+ builder classes under ``bpmn-model/.../builder/``; usage shape:

    model = (Bpmn.create_process("order-process")
             .start_event()
             .service_task("collect-money", type="payment-service")
             .exclusive_gateway("paid?")
             .condition_flow("yes", "$.paid == true")
             .end_event("done")
             .done())
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

from zeebe_tpu_torch.models.bpmn.model import (
    BoundaryEvent,
    BpmnModel,
    EndEvent,
    ExclusiveGateway,
    FlowNode,
    IntermediateCatchEvent,
    Mapping,
    MessageDefinition,
    MultiInstanceLoopCharacteristics,
    OutputBehavior,
    ParallelGateway,
    Process,
    ReceiveTask,
    SequenceFlow,
    ServiceTask,
    StartEvent,
    SubProcess,
    TaskDefinition,
)


class Bpmn:
    @staticmethod
    def create_process(process_id: str = "process") -> "ProcessBuilder":
        return ProcessBuilder(process_id)


class ProcessBuilder:
    """Linear-with-branches builder over a BpmnModel."""

    def __init__(self, process_id: str, model: Optional[BpmnModel] = None, scope_id: str = ""):
        self.model = model or BpmnModel()
        self._ids = itertools.count()
        if scope_id == "":
            self.process = Process(id=process_id)
            self.model.add(self.process)
            self.scope_id = process_id
        else:
            self.scope_id = scope_id
        self._cursor: Optional[FlowNode] = None  # last added node
        self._gateway_stack: List[FlowNode] = []

    # -- helpers -----------------------------------------------------------
    def _gen_id(self, prefix: str) -> str:
        while True:
            candidate = f"{prefix}-{next(self._ids)}"
            if candidate not in self.model.elements:
                return candidate

    def _add_node(self, node: FlowNode, connect: bool = True, condition: Optional[str] = None):
        node.scope_id = self.scope_id
        self.model.add(node)
        if connect and self._cursor is not None:
            self._connect(self._cursor, node, condition)
        self._cursor = node
        return self

    def _connect(self, source: FlowNode, target: FlowNode, condition: Optional[str] = None):
        flow = SequenceFlow(
            id=self._gen_id(f"flow-{source.id}-{target.id}"),
            source_id=source.id,
            target_id=target.id,
            condition_expression=condition,
            scope_id=self.scope_id,
        )
        self.model.add(flow)
        self.model.connect(flow)
        return flow

    # -- node builders -----------------------------------------------------
    def start_event(self, element_id: Optional[str] = None) -> "ProcessBuilder":
        return self._add_node(StartEvent(id=element_id or self._gen_id("start")))

    def end_event(self, element_id: Optional[str] = None) -> "ProcessBuilder":
        return self._add_node(EndEvent(id=element_id or self._gen_id("end")))

    def service_task(
        self,
        element_id: Optional[str] = None,
        *,
        type: str = "",
        retries: int = 3,
        headers: Optional[Dict[str, str]] = None,
        inputs: Optional[List[tuple]] = None,
        outputs: Optional[List[tuple]] = None,
        output_behavior: OutputBehavior = OutputBehavior.MERGE,
    ) -> "ProcessBuilder":
        task = ServiceTask(
            id=element_id or self._gen_id("task"),
            task_definition=TaskDefinition(type=type, retries=retries),
            task_headers=dict(headers or {}),
            input_mappings=[Mapping(s, t) for s, t in (inputs or [])],
            output_mappings=[Mapping(s, t) for s, t in (outputs or [])],
            output_behavior=output_behavior,
        )
        return self._add_node(task)

    def exclusive_gateway(self, element_id: Optional[str] = None) -> "ProcessBuilder":
        gw = ExclusiveGateway(id=element_id or self._gen_id("xor"))
        self._add_node(gw)
        self._gateway_stack.append(gw)
        return self

    def parallel_gateway(self, element_id: Optional[str] = None) -> "ProcessBuilder":
        gw = ParallelGateway(id=element_id or self._gen_id("and"))
        self._add_node(gw)
        self._gateway_stack.append(gw)
        return self

    def message_catch_event(
        self,
        element_id: Optional[str] = None,
        *,
        message_name: str = "",
        correlation_key: str = "",
    ) -> "ProcessBuilder":
        msg = MessageDefinition(name=message_name, correlation_key=correlation_key)
        self.model.messages[message_name] = msg
        return self._add_node(
            IntermediateCatchEvent(
                id=element_id or self._gen_id("catch"), message=msg
            )
        )

    def timer_catch_event(
        self, element_id: Optional[str] = None, *, duration_ms: int = 0
    ) -> "ProcessBuilder":
        return self._add_node(
            IntermediateCatchEvent(
                id=element_id or self._gen_id("timer"), timer_duration_ms=duration_ms
            )
        )

    def receive_task(
        self,
        element_id: Optional[str] = None,
        *,
        message_name: str = "",
        correlation_key: str = "",
    ) -> "ProcessBuilder":
        msg = MessageDefinition(name=message_name, correlation_key=correlation_key)
        self.model.messages[message_name] = msg
        return self._add_node(
            ReceiveTask(id=element_id or self._gen_id("receive"), message=msg)
        )

    def sub_process(
        self,
        element_id: Optional[str] = None,
        *,
        multi_instance: Optional[dict] = None,
    ) -> "SubProcessBuilder":
        """``multi_instance``: dict with ``input_collection`` /
        ``input_element`` / ``cardinality`` / ``output_collection`` keys
        (reference: MultiInstanceLoopCharacteristics on the activity)."""
        sub = SubProcess(
            id=element_id or self._gen_id("subprocess"),
            multi_instance=(
                MultiInstanceLoopCharacteristics(**multi_instance)
                if multi_instance is not None
                else None
            ),
        )
        self._add_node(sub)
        return SubProcessBuilder(self, sub)

    def boundary_event(
        self,
        element_id: Optional[str] = None,
        *,
        attached_to: Optional[str] = None,
        duration_ms: Optional[int] = None,
        message_name: Optional[str] = None,
        correlation_key: str = "",
        interrupting: bool = True,
    ) -> "ProcessBuilder":
        """Attach a boundary event to an activity (the cursor by default).
        The cursor moves onto the boundary event, so the next builder call
        chains the boundary flow; use ``move_to(activity)`` to return to
        the main path (reference builder: ``boundaryEvent`` +
        ``moveToActivity``)."""
        host = (
            self.model.element(attached_to)
            if attached_to is not None
            else self._cursor
        )
        if not isinstance(host, (ServiceTask, SubProcess, ReceiveTask)):
            raise ValueError(
                "boundary events attach to service tasks, receive tasks or sub-processes"
            )
        if (duration_ms is None) == (message_name is None):
            raise ValueError("boundary event needs exactly one of duration_ms / message_name")
        msg = None
        if message_name is not None:
            msg = MessageDefinition(name=message_name, correlation_key=correlation_key)
            self.model.messages[message_name] = msg
        node = BoundaryEvent(
            id=element_id or self._gen_id(f"boundary-{host.id}"),
            attached_to_id=host.id,
            cancel_activity=interrupting,
            timer_duration_ms=duration_ms,
            message=msg,
        )
        node.scope_id = host.scope_id
        self.model.add(node)
        self._cursor = node
        return self

    # -- branching ---------------------------------------------------------
    def branch(self, condition: Optional[str] = None, default: bool = False) -> "BranchBuilder":
        """Open a branch from the most recent gateway."""
        if not self._gateway_stack:
            raise ValueError("branch() requires a preceding gateway")
        return BranchBuilder(self, self._gateway_stack[-1], condition, default)

    def move_to(self, element_id: str) -> "ProcessBuilder":
        node = self.model.element(element_id)
        if not isinstance(node, FlowNode):
            raise ValueError(f"{element_id} is not a flow node")
        self._cursor = node
        if isinstance(node, (ExclusiveGateway, ParallelGateway)):
            if node not in self._gateway_stack:
                self._gateway_stack.append(node)
        return self

    def connect_to(self, element_id: str, condition: Optional[str] = None) -> "ProcessBuilder":
        """Connect the cursor to an existing element (merge edges)."""
        target = self.model.element(element_id)
        self._connect(self._cursor, target, condition)
        return self

    def default_flow_to(self, element_id: str) -> "ProcessBuilder":
        gw = self._gateway_stack[-1]
        if not isinstance(gw, ExclusiveGateway):
            raise ValueError("default flow requires an exclusive gateway")
        flow = self._connect(gw, self.model.element(element_id))
        gw.default_flow_id = flow.id
        return self

    def done(self) -> BpmnModel:
        return self.model


class BranchBuilder(ProcessBuilder):
    """Builds one outgoing branch of a gateway; shares the parent model."""

    def __init__(self, parent: ProcessBuilder, gateway: FlowNode, condition, default):
        self.model = parent.model
        self._ids = parent._ids
        self.scope_id = parent.scope_id
        self.process = getattr(parent, "process", None)
        self._cursor = gateway
        self._gateway_stack = parent._gateway_stack
        self._parent = parent
        self._condition = condition
        self._default = default
        self._first = True

    def _add_node(self, node, connect=True, condition=None):
        if self._first:
            condition = self._condition
            self._first = False
            node.scope_id = self.scope_id
            self.model.add(node)
            flow = self._connect(self._cursor, node, condition)
            if self._default:
                gw = self._cursor
                if isinstance(gw, ExclusiveGateway):
                    gw.default_flow_id = flow.id
            self._cursor = node
            return self
        return super()._add_node(node, connect, condition)

    def connect_to(self, element_id: str, condition: Optional[str] = None):
        if self._first:
            condition = self._condition
            self._first = False
            flow = self._connect(self._cursor, self.model.element(element_id), condition)
            if self._default and isinstance(self._cursor, ExclusiveGateway):
                self._cursor.default_flow_id = flow.id
            return self
        return super().connect_to(element_id, condition)


class SubProcessBuilder(ProcessBuilder):
    """Builds the embedded scope of a sub-process."""

    def __init__(self, parent: ProcessBuilder, subprocess_node: SubProcess):
        self.model = parent.model
        self._ids = parent._ids
        self.scope_id = subprocess_node.id
        self.process = getattr(parent, "process", None)
        self._cursor = None
        self._gateway_stack = []
        self._parent = parent
        self._subprocess = subprocess_node

    def embedded_done(self) -> ProcessBuilder:
        """Close the embedded scope; cursor returns to the sub-process node."""
        self._parent._cursor = self._subprocess
        return self._parent
