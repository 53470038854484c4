"""Graph, partition, GAS model, algorithms, superstep core, engine and
the paper's performance model."""
from . import algorithms, gas, graph, partition, perfmodel, stepper
from .engine import Engine, EngineResult, collect

__all__ = ["Engine", "EngineResult", "algorithms", "collect", "gas",
           "graph", "partition", "perfmodel", "stepper"]
