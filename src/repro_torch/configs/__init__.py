"""Assigned-architecture registry (the port's copy of ``repro.configs``):
``get(name)`` resolves an arch id to its full or reduced ``ArchCfg``.

Ten LM-family architectures, each a dataclass literal, every one served
by the port. The id lists below group them by the blocks they run."""
from __future__ import annotations

from importlib import import_module
from typing import Dict

from .common import SHAPES, Shape, input_specs, reduce_cfg, shape_applicable

__all__ = ["ARCH_IDS", "DENSE_IDS", "ENCDEC_IDS", "MLA_IDS", "MOE_IDS",
           "RECURRENT_IDS", "SHAPES", "Shape", "all_configs", "get",
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


def _kinds(name: str):
    cfg = get(name)
    return cfg, cfg.block_pattern + cfg.tail


def _ids(pred) -> tuple:
    return tuple(a for a in ARCH_IDS if pred(*_kinds(a)))


# Decoder-only dense GQA: every block mixer="attn" with ffn "mlp" or "none".
DENSE_IDS = _ids(lambda cfg, kinds: cfg.family != "encdec" and all(
    k.mixer == "attn" and k.ffn in ("mlp", "none") for k in kinds))
# A block with routed experts (ffn="moe").
MOE_IDS = _ids(lambda cfg, kinds: any(k.ffn == "moe" for k in kinds))
# A block with latent attention (mixer="mla").
MLA_IDS = _ids(lambda cfg, kinds: any(k.mixer == "mla" for k in kinds))
# A block with a recurrent mixer (rglru, mlstm, slstm).
RECURRENT_IDS = _ids(lambda cfg, kinds: any(
    k.mixer in ("rglru", "mlstm", "slstm") for k in kinds))
# Encoder-decoder (models/encdec.py).
ENCDEC_IDS = _ids(lambda cfg, kinds: cfg.family == "encdec")


def all_configs(reduced: bool = False) -> Dict[str, object]:
    return {n: get(n, reduced=reduced) for n in ARCH_IDS}
