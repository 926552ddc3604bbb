from .base import Input, InputLayer, KerasLayer
from .graph import GraphFunction, Node, Variable
from .topology import KerasNet, Model

__all__ = ["Input", "InputLayer", "KerasLayer", "GraphFunction", "Node",
           "Variable", "KerasNet", "Model"]
