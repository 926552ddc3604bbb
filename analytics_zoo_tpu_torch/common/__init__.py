from .nncontext import (ZooConfig, ZooContext, get_nncontext, init_nncontext,
                        set_nncontext)

__all__ = ["ZooConfig", "ZooContext", "get_nncontext", "init_nncontext",
           "set_nncontext"]
