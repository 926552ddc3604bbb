"""Runtime context: config and the device the entry points run on.

Counterpart of ``analytics_zoo_tpu/common/nncontext.py``. The JAX context
builds a device mesh over every visible chip; this one holds one
``torch.device``. ``init_nncontext()`` with no device selects ``cuda:0``
and raises when no CUDA device is present — it never falls back to the
CPU; a caller that wants the CPU asks for it (``device="cpu"``). The
mesh, multi-process initialisation and compile cache arrive with later
slices.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import torch

logger = logging.getLogger("analytics_zoo_tpu_torch")

_global_context = None


@dataclasses.dataclass
class ZooConfig:
    """Typed config with env-var overrides (prefix ``ZOO_TPU_``, shared
    with the JAX package so one environment configures both). Only the
    fields the ported path reads."""

    # parallel degrees; the port runs on one device, so anything above 1
    # reaches a NotImplementedError in the layer that would need it
    data_parallel: int = 1
    sequence_parallel: int = 1
    pipeline_parallel: int = 1
    # seed for weights a model draws when it is built
    seed: int = 42

    @classmethod
    def from_env(cls, **overrides):
        cfg = cls(**overrides)
        for f in dataclasses.fields(cls):
            env = os.environ.get("ZOO_TPU_" + f.name.upper())
            if env is None:
                continue
            try:
                setattr(cfg, f.name, int(env))
            except ValueError as e:
                raise ValueError(f"bad value for ZOO_TPU_{f.name.upper()}: "
                                 f"{env!r}") from e
        return cfg


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_nncontext(): no CUDA device is visible. The port runs "
                "on the GPU unless asked otherwise; pass device='cpu' to "
                "run on the CPU.")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA device "
                               "is visible")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev


class ZooContext:
    """Holds the config and the ``torch.device``. One per process."""

    def __init__(self, config: Optional[ZooConfig] = None, device=None):
        self.config = config or ZooConfig.from_env()
        self.device = _resolve_device(device)
        logger.info("ZooContext: device %s", self.device)


def init_nncontext(conf=None, cluster_mode: str = "local", device=None,
                   **kwargs) -> ZooContext:
    """Initialize (or fetch) the global context.

    Mirrors ``init_nncontext`` (pyzoo/zoo/common/nncontext.py:23);
    ``cluster_mode`` is accepted for API parity. ``device`` None selects
    ``cuda:0`` and raises without a CUDA device."""
    global _global_context
    if _global_context is None:
        if isinstance(conf, ZooConfig):
            cfg = conf
        elif isinstance(conf, dict):
            cfg = ZooConfig.from_env(**conf)
        else:
            cfg = ZooConfig.from_env(**kwargs)
        _global_context = ZooContext(cfg, device=device)
    return _global_context


def get_nncontext() -> ZooContext:
    return init_nncontext()


def set_nncontext(ctx: Optional[ZooContext]):
    global _global_context
    _global_context = ctx
