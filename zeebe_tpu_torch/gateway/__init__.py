"""Client API + job workers (reference: ``gateway/``, ``clients/``)."""

from zeebe_tpu_torch.gateway.client import ZeebeClient, ClientException, TopicSubscriber
from zeebe_tpu_torch.gateway.workers import JobWorker

__all__ = ["ZeebeClient", "ClientException", "JobWorker", "TopicSubscriber"]
