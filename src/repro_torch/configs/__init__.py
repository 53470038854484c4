"""Assigned-architecture registry (the port's copy of ``repro.configs``):
``get(name)`` resolves an arch id to its full or reduced ``ArchCfg``.

Ten LM-family architectures, each a dataclass literal. The dense GQA five
(qwen3-4b, qwen2-72b, minitron-4b, gemma3-27b, internvl2-76b) run in the
port; the others' mixers raise ``NotImplementedError`` when a model is
built from them."""
from __future__ import annotations

from importlib import import_module
from typing import Dict

from ..models.lm import is_ported
from .common import SHAPES, Shape, input_specs, reduce_cfg, shape_applicable

__all__ = ["ARCH_IDS", "DENSE_IDS", "SHAPES", "Shape", "all_configs", "get",
           "input_specs", "reduce_cfg", "shape_applicable"]

_MODULES = {
    "xlstm-350m": "xlstm_350m",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "qwen3-4b": "qwen3_4b",
    "qwen2-72b": "qwen2_72b",
    "gemma3-27b": "gemma3_27b",
    "minitron-4b": "minitron_4b",
    "internvl2-76b": "internvl2_76b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "deepseek-v2-236b": "deepseek_v2_236b",
}

ARCH_IDS = tuple(_MODULES)


def get(name: str, *, reduced: bool = False):
    mod = import_module(f".{_MODULES[name]}", __package__)
    return mod.reduced() if reduced else mod.config()


# The archs the port runs: every block mixer="attn" with ffn="mlp".
DENSE_IDS = tuple(a for a in ARCH_IDS if is_ported(get(a)))


def all_configs(reduced: bool = False) -> Dict[str, object]:
    return {n: get(n, reduced=reduced) for n in ARCH_IDS}
