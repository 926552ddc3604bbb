from .raycontext import (ActorClass, ActorHandle, ObjectRef, RayContext,
                         RemoteFunction, RemoteTaskError, WorkerLostError,
                         get_ray_context)
from .process import ProcessMonitor, ProcessGuard

__all__ = ["RayContext", "RemoteFunction", "ActorClass", "ActorHandle",
           "ObjectRef", "RemoteTaskError", "WorkerLostError",
           "get_ray_context", "ProcessMonitor", "ProcessGuard"]
