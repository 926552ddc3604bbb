"""Process supervision (counterpart of ``analytics_zoo_tpu/launcher/``).

Only the supervisor is ported: the serving fleet builds on it. The
multi-host launcher (``launch.py``, ``worker.py``) waits for its own
slice (ROADMAP A12).
"""

from .supervisor import (Respawner, SupervisedProc, inject_pythonpath,
                         pump_lines, spawn_supervised, terminate_all)

__all__ = ["inject_pythonpath", "pump_lines", "spawn_supervised",
           "SupervisedProc", "Respawner", "terminate_all"]
