"""Executable workflow graph (host form).

Reference parity: ``broker-core/.../workflow/model/Executable*.java`` —
a flat graph of executable elements with a per-element map
lifecycle-state → BpmnStep bound at transform time
(``ExecutableFlowElement.getStep``, ExecutableFlowElement.java:44).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from zeebe_tpu_torch.models.bpmn.model import ElementType, Mapping, OutputBehavior
from zeebe_tpu_torch.models.el.ast import Condition
from zeebe_tpu_torch.models.transform.steps import BpmnStep
from zeebe_tpu_torch.protocol.intents import WorkflowInstanceIntent


@dataclasses.dataclass
class ExecutableFlowElement:
    id: str
    index: int  # dense index within the workflow's element table
    element_type: ElementType
    steps: Dict[WorkflowInstanceIntent, BpmnStep] = dataclasses.field(default_factory=dict)
    scope_id: str = ""  # containing process/subprocess element id

    # flow nodes
    outgoing: List["ExecutableFlowElement"] = dataclasses.field(default_factory=list)
    incoming: List["ExecutableFlowElement"] = dataclasses.field(default_factory=list)
    input_mappings: List[Mapping] = dataclasses.field(default_factory=list)
    output_mappings: List[Mapping] = dataclasses.field(default_factory=list)
    output_behavior: OutputBehavior = OutputBehavior.MERGE

    # sequence flows
    target: Optional["ExecutableFlowElement"] = None
    source: Optional["ExecutableFlowElement"] = None
    condition: Optional[Condition] = None
    condition_text: Optional[str] = None

    # service tasks
    job_type: str = ""
    job_retries: int = 3
    job_headers: Dict[str, str] = dataclasses.field(default_factory=dict)

    # exclusive gateway
    default_flow: Optional["ExecutableFlowElement"] = None

    # containers (process / sub-process)
    start_event: Optional["ExecutableFlowElement"] = None

    # message catch
    message_name: str = ""
    correlation_key_path: str = ""

    # timer catch
    timer_duration_ms: Optional[int] = None

    # boundary events (reference BoundaryEvent.java + cancelActivity)
    attached_to: Optional["ExecutableFlowElement"] = None
    boundary_events: List["ExecutableFlowElement"] = dataclasses.field(
        default_factory=list
    )
    cancel_activity: bool = True

    # multi-instance (reference MultiInstanceLoopCharacteristics.java)
    mi_input_collection: str = ""
    mi_input_element: str = ""
    mi_cardinality: Optional[int] = None
    mi_output_collection: str = ""
    mi_output_element: str = ""
    is_multi_instance: bool = False

    def bind(self, state: WorkflowInstanceIntent, step: BpmnStep) -> None:
        # Reference: ExecutableFlowElement.bindLifecycleState
        self.steps[state] = step

    def get_step(self, state: WorkflowInstanceIntent) -> BpmnStep:
        return self.steps.get(state, BpmnStep.NONE)

    @property
    def outgoing_with_condition(self) -> List["ExecutableFlowElement"]:
        return [f for f in self.outgoing if f.condition is not None]


@dataclasses.dataclass
class ExecutableWorkflow:
    """Reference: ExecutableWorkflow (the process element doubles as the
    root scope element, index 0)."""

    id: str  # bpmn process id
    elements: List[ExecutableFlowElement] = dataclasses.field(default_factory=list)
    by_id: Dict[str, ExecutableFlowElement] = dataclasses.field(default_factory=dict)
    version: int = -1
    key: int = -1
    # deployed source, retained so the system partition can serve
    # fetch-workflow requests (reference WorkflowRepositoryIndex keeps the
    # resource for FetchWorkflowRequest responses)
    source_resource: bytes = b""
    source_type: str = "BPMN_XML"

    def add(self, element: ExecutableFlowElement) -> None:
        self.elements.append(element)
        self.by_id[element.id] = element

    def element_by_id(self, element_id: str) -> Optional[ExecutableFlowElement]:
        return self.by_id.get(element_id)

    @property
    def root(self) -> ExecutableFlowElement:
        return self.elements[0]
