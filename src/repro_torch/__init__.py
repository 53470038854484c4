"""GraVF-M in PyTorch: the port of the ``repro`` package to an NVIDIA H100.

The single-device GraVF-M engine (``Engine(mode="gravfm")``: ``run`` and
``run_batch``) over the five built-in GAS kernels, running through a
hand-written CUDA segment-combine kernel on the card. The package imports
neither JAX nor anything of the JAX package: it keeps its own copies of
the host-side (numpy) graph, partition and layout code.
"""
from . import convert
from .core import algorithms
from .core.engine import Engine, EngineResult, collect
from .core.graph import Graph
from .core.partition import PartitionedGraph, partition_graph

__all__ = ["Engine", "EngineResult", "Graph", "PartitionedGraph",
           "algorithms", "collect", "convert", "partition_graph"]
