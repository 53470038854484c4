"""Graph, partition, GAS model, algorithms, superstep core and engine."""
from . import algorithms, gas, graph, partition, stepper
from .engine import Engine, EngineResult, collect

__all__ = ["Engine", "EngineResult", "algorithms", "collect", "gas",
           "graph", "partition", "stepper"]
