"""Cluster Serving: the streaming serve loop, its queues and client, the
model registry and router, generative decode engines, the
continuous-batching scheduler, deadline-aware admission, the network
transports, the supervised fleet and the ``zoo-serving`` CLI.

Counterpart of ``analytics_zoo_tpu/serving/``, whole but for the JAX
package's smoke drivers (their checks are the port's tests and
``chip_smoke.py``'s ``fleet`` phase): the serve loop
(``cluster_serving.py``), the in-process, file and Redis queues
(``queue_backend.py``, on the port's msgpack codec ``wire.py``), the
socket broker and its shard fabric (``socket_queue.py``,
``shard_fabric.py``), the client (``client.py``), the registry and
router (``registry.py``, ``router.py``), generation (``generation.py``),
admission (``admission.py``), the fleet and its workers (``fleet.py``,
``fleet_worker.py``), routed generate placement (``routing.py``) and
the CLI (``cli.py``: ``python -m analytics_zoo_tpu_torch.serving.cli``).
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
from .fleet import ServingFleet, fleet_status, read_autoscale_trace
from .generation import (ContinuousBatchScheduler, GenRequest, PrefixCache,
                         SpeculativeDecodeEngine, StubDecodeEngine,
                         TransformerDecodeEngine)
from .queue_backend import (DeliveryLedger, FileStreamQueue,
                            InProcessStreamQueue, StreamQueue,
                            get_queue_backend)
from .routing import (GenerateRouter, RouteDecision, RoutedGenerateQueue,
                      WorkerIntakeQueue, WorkerReport)
from .shard_fabric import (LocalShardFabric, ShardedStreamQueue,
                           parse_shard_spec)
from .socket_queue import SocketStreamQueue, StreamQueueBroker
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
           "TenantScheduler", "ServingFleet", "fleet_status",
           "read_autoscale_trace", "DeliveryLedger", "SocketStreamQueue",
           "StreamQueueBroker", "ShardedStreamQueue", "LocalShardFabric",
           "parse_shard_spec",
           "GenerationResult", "ContinuousBatchScheduler", "GenRequest",
           "PrefixCache", "SpeculativeDecodeEngine", "StubDecodeEngine",
           "TransformerDecodeEngine",
           "GenerateRouter", "RouteDecision", "RoutedGenerateQueue",
           "WorkerIntakeQueue", "WorkerReport"]
