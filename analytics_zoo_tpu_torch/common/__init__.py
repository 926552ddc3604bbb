from .nncontext import (ZooConfig, ZooContext, get_nncontext, init_nncontext,
                        set_nncontext)
from .zoo_trigger import (And, EveryEpoch, MaxEpoch, MaxIteration, MaxScore,
                          MinLoss, Or, SeveralIteration, TrainRecord,
                          ZooTrigger)

__all__ = ["ZooConfig", "ZooContext", "get_nncontext", "init_nncontext",
           "set_nncontext", "And", "EveryEpoch", "MaxEpoch", "MaxIteration",
           "MaxScore", "MinLoss", "Or", "SeveralIteration", "TrainRecord",
           "ZooTrigger"]
