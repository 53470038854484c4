"""Kernel layer: the static edge layout, the segment-combine kernel (CUDA
on the card, plain PyTorch on the CPU), its oracle and the dispatch."""
from . import edge_gather, layout, ops, ref

__all__ = ["edge_gather", "layout", "ops", "ref"]
