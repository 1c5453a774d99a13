"""BPMN 2.0 meta-model (reference: ``bpmn-model/`` module)."""

from zeebe_tpu_torch.models.bpmn.model import (
    BpmnModel,
    ElementType,
    FlowElement,
    FlowNode,
    Process,
    SequenceFlow,
)
from zeebe_tpu_torch.models.bpmn.builder import Bpmn

__all__ = [
    "BpmnModel",
    "ElementType",
    "FlowElement",
    "FlowNode",
    "Process",
    "SequenceFlow",
    "Bpmn",
]
