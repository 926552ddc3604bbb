from .base import Input, InputLayer, KerasLayer
from .graph import GraphFunction, Node, Variable
from .topology import KerasNet, Model, Sequential

__all__ = ["Input", "InputLayer", "KerasLayer", "GraphFunction", "Node",
           "Variable", "KerasNet", "Model", "Sequential"]
