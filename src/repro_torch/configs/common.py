"""Shared shape-set and input-spec machinery for the assigned
architectures.

Every LM-family arch is paired with the same four shapes:

  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> serve prefill
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token,
                                                 KV cache of seq_len)
  long_500k    seq 524,288 global_batch 1     -> serve_step; ONLY for
               sub-quadratic archs (cfg.long_context_ok) — skips recorded
               in DESIGN.md §Arch-applicability.

``input_specs`` returns ``meta`` tensors (shapes and dtypes, no
allocation) for the DATA inputs of each step; params and caches get their
own abstract constructors in models/. The port's copy of
``repro.configs.common``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..models.lm import ArchCfg

__all__ = ["Shape", "SHAPES", "shape_applicable", "input_specs",
           "reduce_cfg"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}

ENC_LEN_CAP = 4_096  # encoder frame budget for enc-dec (seamless) shapes


def shape_applicable(cfg: ArchCfg, shape: Shape) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape.name == "long_500k" and not cfg.long_context_ok:
        return False, ("pure full-attention arch: 500k dense prefill is "
                       "quadratic; skipped per assignment rules "
                       "(DESIGN.md §8)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchCfg, shape: Shape) -> Dict[str, torch.Tensor]:
    """Data inputs for the step function of (cfg, shape), as ``meta``
    tensors."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.family == "encdec":
        enc_len = min(S, ENC_LEN_CAP)
        if shape.kind == "train":
            return {
                "frames": _meta((B, enc_len, cfg.d_model),
                                torch.bfloat16),
                "tokens": _meta((B, S), i32),
                "labels": _meta((B, S), i32),
            }
        if shape.kind == "prefill":
            return {
                "frames": _meta((B, enc_len, cfg.d_model),
                                torch.bfloat16),
                "tokens": _meta((B, S), i32),
            }
        return {"tokens": _meta((B, 1), i32),
                "pos": _meta((), i32)}

    if cfg.family == "vlm" and shape.kind != "decode":
        n_text = S - cfg.prefix_len
        return {
            "patch_embeds": _meta(
                (B, cfg.prefix_len, cfg.d_model), torch.bfloat16),
            "tokens": _meta((B, n_text), i32),
            **({"labels": _meta((B, n_text), i32)}
               if shape.kind == "train" else {}),
        }

    if shape.kind == "train":
        return {"tokens": _meta((B, S), i32),
                "labels": _meta((B, S), i32)}
    if shape.kind == "prefill":
        return {"tokens": _meta((B, S), i32)}
    return {"tokens": _meta((B, 1), i32),
            "pos": _meta((), i32)}


# ---------------------------------------------------------------------------

def reduce_cfg(cfg: ArchCfg, **overrides) -> ArchCfg:
    """Same-family reduced config for CPU smoke tests: small widths, few
    layers/experts, tiny vocab. Pattern structure is preserved."""
    small: Dict = dict(
        d_model=64,
        n_heads=4,
        n_kv=min(cfg.n_kv, 2) if cfg.n_kv < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        repeats=min(cfg.repeats, 2),
        q_chunk=32,
        kv_chunk=32,
        prefix_len=4 if cfg.prefix_len else 0,
        n_enc=min(cfg.n_enc, 2),
        n_dec=min(cfg.n_dec, 2),
        remat=False,
        lru_width=64 if cfg.lru_width else None,
        xlstm_heads=2,
    )
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe, n_routed=8, n_shared=min(cfg.moe.n_shared, 1),
            topk=2, d_ff_expert=32)
    if cfg.mla is not None:
        small["mla"] = dataclasses.replace(
            cfg.mla, q_lora=32, kv_lora=16, qk_nope=16, qk_rope=8, v_dim=16)
    # shrink windows proportionally
    new_pattern = tuple(
        dataclasses.replace(k, window=(16 if k.window else None))
        for k in cfg.block_pattern)
    new_tail = tuple(
        dataclasses.replace(k, window=(16 if k.window else None))
        for k in cfg.tail)
    small["block_pattern"] = new_pattern
    small["tail"] = new_tail
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
