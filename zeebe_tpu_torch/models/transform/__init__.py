"""Deploy-time transformation: BPMN model → executable graph → tensors.

Reference parity: ``broker-core/.../workflow/model/transformation/``
(BpmnTransformer + 12 handlers binding per-(element, lifecycle-intent)
steps) and ``broker-core/.../workflow/model/BpmnStep.java``.
"""

from zeebe_tpu_torch.models.transform.steps import BpmnStep
from zeebe_tpu_torch.models.transform.executable import (
    ExecutableFlowElement,
    ExecutableWorkflow,
)
from zeebe_tpu_torch.models.transform.transformer import transform_model

__all__ = [
    "BpmnStep",
    "ExecutableFlowElement",
    "ExecutableWorkflow",
    "transform_model",
]
