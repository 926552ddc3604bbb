"""The launcher and process supervision (counterpart of
``analytics_zoo_tpu/launcher/``).

``python -m analytics_zoo_tpu_torch.launcher.cli --hosts N train.py``
spawns N worker processes, picks a rendezvous address, propagates the
``ZOO_TPU_COORDINATOR/NUM_PROCESSES/PROCESS_ID`` environment contract that
``init_nncontext`` consumes (joining ``torch.distributed``), fans worker
logs into prefixed streams and supervises the gang under one of three
failure policies (``kill-all``, ``report``, ``restart`` with
``ZOO_TPU_AUTO_RESUME=1``). The serving fleet reuses the supervisor's
primitives.
"""

from .launch import HostSpec, LaunchError, launch, parse_hosts_file
from .supervisor import (Respawner, SupervisedProc, inject_pythonpath,
                         pump_lines, spawn_supervised, terminate_all)

__all__ = ["HostSpec", "LaunchError", "launch", "parse_hosts_file",
           "inject_pythonpath", "pump_lines", "spawn_supervised",
           "SupervisedProc", "Respawner", "terminate_all"]
