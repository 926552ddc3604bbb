"""Data and sequence parallelism over a mesh of ranks.

Counterpart of ``analytics_zoo_tpu/parallel``: the rank mesh
(``mesh.py``), the differentiable collectives (``collectives.py``,
port-only), ZeRO-1 (``zero.py``), Ulysses and ring attention. The
sharding rules and GPipe (``sharding.py``, ``pipeline.py``) arrive with
ROADMAP A12.2.
"""

from .mesh import AXES, RankMesh, make_mesh
from .ring_attention import (ring_attention, ring_attention_blhd,
                             ring_attention_blhd_sharded,
                             ring_attention_sharded)
from .ulysses import (ulysses_attention, ulysses_attention_blhd,
                      ulysses_attention_blhd_sharded,
                      ulysses_attention_sharded)

__all__ = ["AXES", "RankMesh", "make_mesh", "ring_attention",
           "ring_attention_blhd", "ring_attention_blhd_sharded",
           "ring_attention_sharded", "ulysses_attention",
           "ulysses_attention_blhd", "ulysses_attention_blhd_sharded",
           "ulysses_attention_sharded"]
