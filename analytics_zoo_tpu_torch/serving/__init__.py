"""Serving: generative decode engines, the continuous-batching scheduler
and deadline-aware admission.

Counterpart of ``analytics_zoo_tpu/serving/``. Ported so far: generation
(``generation.py``) and the admission controller it consults
(``admission.py``). The Cluster Serving loop, its queues, the fleet and
the routers arrive with a later slice.
"""

from .admission import (AdaptiveBatcher, AdmissionController,
                        BacklogAutoscaler, SHED_CAPACITY, SHED_DEADLINE,
                        SHED_EXPIRED, TenantScheduler)
from .generation import (ContinuousBatchScheduler, GenRequest, PrefixCache,
                         SpeculativeDecodeEngine, StubDecodeEngine,
                         TransformerDecodeEngine)

__all__ = ["AdaptiveBatcher", "AdmissionController", "BacklogAutoscaler",
           "SHED_CAPACITY", "SHED_DEADLINE", "SHED_EXPIRED",
           "TenantScheduler", "ContinuousBatchScheduler", "GenRequest",
           "PrefixCache", "SpeculativeDecodeEngine", "StubDecodeEngine",
           "TransformerDecodeEngine"]
