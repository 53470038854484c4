"""Serving substrate: prefill/decode with static cache buffers."""
from .engine import greedy_generate, make_serve_fns, place_prefill_cache

__all__ = ["greedy_generate", "make_serve_fns", "place_prefill_cache"]
