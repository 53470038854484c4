"""GraVF-M in PyTorch: the port of the ``repro`` package to an NVIDIA H100.

Layout:
  core/      the GraVF-M engine on one device (``Engine``: ``mode="gravfm"``
             and the ``"gravf"`` baseline; ``run``, ``run_batch``, lane
             steppers, offload/upload), the explicit-collective shard
             engine (``ShardEngine`` over ``core/mesh.py``), the five
             built-in GAS kernels, the lane lifecycle (``LaneTable``) and
             the paper's §5 performance model
  kernels/   the hand-written CUDA segment-combine kernel for Hopper
             (``csrc/segment_combine.cu``, K1 and K2), its plain PyTorch
             versions and the ``scatter_reduce_`` oracle
  store/     the versioned, memory-budgeted graph store with host spill
  service/   the query service (``GraphQueryService``: bucketed,
             continuous and preemptible scheduling, plan cache, result
             cache, tracing, metrics)
  models/    the LM substrate's layers, every mixer, the decoder-only
             LM (``LanguageModel``) and the encoder-decoder, with
             ``configs/`` (the ten assigned architectures), ``serve/``
             (prefill, in-place decode and greedy generation over static
             KV buffers), ``train/`` (AdamW, the train step with remat
             and microbatching, checkpoints, int8 compression, the
             ``Trainer``) and ``data/`` (deterministic synthetic tokens)

Entry points run on the card unless ``device="cpu"`` is given, where the
kernels' plain versions run in their place. The package imports neither
JAX nor anything of the JAX package: it keeps its own copies of the
framework-free modules it needs.
"""
from . import convert
from .core import algorithms
from .core.engine import Engine, EngineResult, collect
from .core.engine_shardmap import ShardEngine
from .core.graph import Graph
from .core.partition import PartitionedGraph, partition_graph
from .service import GraphQueryService, QueryRequest
from .store import GraphStore

__all__ = ["Engine", "EngineResult", "Graph", "GraphQueryService",
           "GraphStore", "PartitionedGraph", "QueryRequest", "ShardEngine",
           "algorithms", "collect", "convert", "partition_graph"]
