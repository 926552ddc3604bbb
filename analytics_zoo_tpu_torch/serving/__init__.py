"""Cluster Serving: the streaming serve loop, its queues and client, the
model registry and router, generative decode engines, the
continuous-batching scheduler and deadline-aware admission.

Counterpart of ``analytics_zoo_tpu/serving/``. Ported: the serve loop
(``cluster_serving.py``), the in-process, file and Redis queues
(``queue_backend.py``, on the port's msgpack codec ``wire.py``), the
client (``client.py``), the registry and router (``registry.py``,
``router.py``), generation (``generation.py``) and admission
(``admission.py``). The socket broker, the shard fabric, the fleet, the
generate router and the ``zoo-serving`` CLI arrive with later slices
(ROADMAP A14).
"""

from .admission import (AdaptiveBatcher, AdmissionController,
                        BacklogAutoscaler, SHED_CAPACITY, SHED_DEADLINE,
                        SHED_EXPIRED, TenantScheduler)
from .client import (API, GenerationResult, InputQueue, OutputQueue,
                     ServingError, ServingRejected, ServingResult,
                     ServingTimeout)
from .cluster_serving import (ClusterServing, ClusterServingHelper,
                              EchoStubModel, RecordMeta, pick_bucket,
                              power_of_two_buckets)
from .generation import (ContinuousBatchScheduler, GenRequest, PrefixCache,
                         SpeculativeDecodeEngine, StubDecodeEngine,
                         TransformerDecodeEngine)
from .queue_backend import (DeliveryLedger, FileStreamQueue,
                            InProcessStreamQueue, StreamQueue,
                            get_queue_backend)
from .registry import (CanaryState, DeployError, ModelRegistry,
                       ModelVersion, RegistryControlServer, RegistryError,
                       UnknownModelError, control_request)
from .router import RoutedClusterServing

__all__ = ["InputQueue", "OutputQueue", "API", "ServingError",
           "ServingRejected", "ServingResult", "ServingTimeout",
           "ClusterServing", "ClusterServingHelper", "EchoStubModel",
           "RecordMeta", "StreamQueue",
           "InProcessStreamQueue", "FileStreamQueue", "get_queue_backend",
           "pick_bucket", "power_of_two_buckets", "ModelRegistry",
           "ModelVersion", "CanaryState", "RegistryError",
           "UnknownModelError", "DeployError", "RegistryControlServer",
           "control_request", "RoutedClusterServing",
           "AdmissionController", "AdaptiveBatcher", "BacklogAutoscaler",
           "SHED_DEADLINE", "SHED_EXPIRED", "SHED_CAPACITY",
           "TenantScheduler", "DeliveryLedger",
           "GenerationResult", "ContinuousBatchScheduler", "GenRequest",
           "PrefixCache", "SpeculativeDecodeEngine", "StubDecodeEngine",
           "TransformerDecodeEngine"]
