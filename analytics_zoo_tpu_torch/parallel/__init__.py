"""Parallelism over a mesh of ranks.

Counterpart of ``analytics_zoo_tpu/parallel``: the rank mesh
(``mesh.py``), the differentiable collectives (``collectives.py``,
port-only), the sharding rules and the parameters' layout over the ranks
(``sharding.py``), GPipe (``pipeline.py``), ZeRO-1 (``zero.py``),
Ulysses and ring attention.
"""

from .mesh import AXES, RankMesh, make_mesh
from .pipeline import (pipeline_forward, sequential_reference,
                       stack_stage_params, stage_param_sharding)
from .ring_attention import (ring_attention, ring_attention_blhd,
                             ring_attention_blhd_sharded,
                             ring_attention_sharded)
from .sharding import (DEFAULT_RULES, FSDP_RULES, make_param_sharding_fn,
                       shard_params)
from .ulysses import (ulysses_attention, ulysses_attention_blhd,
                      ulysses_attention_blhd_sharded,
                      ulysses_attention_sharded)

__all__ = ["AXES", "RankMesh", "make_mesh", "ring_attention",
           "ring_attention_blhd", "ring_attention_blhd_sharded",
           "ring_attention_sharded", "ulysses_attention",
           "ulysses_attention_blhd", "ulysses_attention_blhd_sharded",
           "ulysses_attention_sharded", "DEFAULT_RULES", "FSDP_RULES",
           "make_param_sharding_fn", "shard_params", "pipeline_forward",
           "sequential_reference", "stack_stage_params",
           "stage_param_sharding"]
