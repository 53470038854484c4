"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), in
PyTorch (the port of ``repro.models.mla``).

KV is compressed to a ``kv_lora`` latent (512) plus one shared decoupled
RoPE key (64) per token: the cache stores 576 dims a token whatever the
number of heads. Prefill materializes full K/V and runs the shared
blockwise attention, with v padded to the q/k width. Decode uses the
ABSORBED form: q_nope is folded through W_uk so scores are taken against
the latent cache in float32, and the context is un-projected through W_uv
afterwards; full K/V are never built at decode time.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .layers import (PSpec, blockwise_attention, dense, heads_einsum,
                     masked_cache_update, rmsnorm, rope)

__all__ = ["mla_spec", "mla_full", "mla_decode"]


def mla_spec(d_model: int, n_heads: int, *, q_lora: int = 1536,
             kv_lora: int = 512, qk_nope: int = 128, qk_rope: int = 64,
             v_dim: int = 128,
             stack: Optional[int] = None) -> Dict[str, PSpec]:
    st = (stack,) if stack else ()
    pre = "stack," if stack else ""
    return {
        "w_dq": PSpec(st + (d_model, q_lora), pre + "fsdp,.",
                      fan_in=d_model),
        "q_norm": PSpec(st + (q_lora,), pre + ".", init="ones"),
        "w_uq": PSpec(st + (q_lora, n_heads, qk_nope + qk_rope),
                      pre + "fsdp,heads,.", fan_in=q_lora),
        "w_dkv": PSpec(st + (d_model, kv_lora + qk_rope), pre + "fsdp,.",
                       fan_in=d_model),
        "kv_norm": PSpec(st + (kv_lora,), pre + ".", init="ones"),
        "w_uk": PSpec(st + (kv_lora, n_heads, qk_nope),
                      pre + ".,heads,.", fan_in=kv_lora),
        "w_uv": PSpec(st + (kv_lora, n_heads, v_dim),
                      pre + ".,heads,.", fan_in=kv_lora),
        "w_o": PSpec(st + (n_heads, v_dim, d_model), pre + "heads,.,fsdp",
                     fan_in=n_heads * v_dim),
    }


def _project(p, x, positions, *, qk_nope, qk_rope, kv_lora,
             rope_base=10000.0):
    q_lat = rmsnorm(dense(x, p["w_dq"]), p["q_norm"])
    q = heads_einsum("bsl,lhk->bshk", q_lat, p["w_uq"])
    q_nope, q_pe = q[..., :qk_nope], q[..., qk_nope:]
    q_pe = rope(q_pe, positions, base=rope_base)

    dkv = dense(x, p["w_dkv"])
    c_kv = rmsnorm(dkv[..., :kv_lora], p["kv_norm"])       # (B,S,kv_lora)
    k_pe = dkv[..., kv_lora:][:, :, None, :]               # (B,S,1,rope)
    k_pe = rope(k_pe, positions, base=rope_base)
    return q_nope, q_pe, c_kv, k_pe


def mla_full(p, x, *, qk_nope: int = 128, qk_rope: int = 64,
             kv_lora: int = 512, v_dim: int = 128,
             rope_base: float = 10000.0, q_chunk: int = 512,
             kv_chunk: int = 1024):
    """Prefill. x: (B, S, D). Returns (out, (c_kv, k_pe)), the decode
    cache: (B, S, kv_lora) and (B, S, qk_rope), k_pe roped."""
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q_nope, q_pe, c_kv, k_pe = _project(
        p, x, positions, qk_nope=qk_nope, qk_rope=qk_rope, kv_lora=kv_lora,
        rope_base=rope_base)
    H = q_nope.shape[2]
    k_nope = heads_einsum("bsl,lhk->bshk", c_kv, p["w_uk"])
    v = heads_einsum("bsl,lhk->bshk", c_kv, p["w_uv"])
    k = torch.cat([k_nope, k_pe.expand(B, S, H, qk_rope)], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    # v padded to the q/k width for the shared blockwise attention
    scale = 1.0 / math.sqrt(qk_nope + qk_rope)
    v_in = F.pad(v, (0, q.shape[-1] - v_dim)) if v_dim != q.shape[-1] else v
    out = blockwise_attention(q, k, v_in, causal=True, scale=scale,
                              q_chunk=q_chunk, kv_chunk=kv_chunk)
    out = out[..., :v_dim]
    out = heads_einsum("bshk,hkd->bsd", out, p["w_o"])
    return out, (c_kv, k_pe[:, :, 0, :])


def mla_decode(p, x, cache_ckv, cache_kpe, pos, *, qk_nope: int = 128,
               qk_rope: int = 64, kv_lora: int = 512, v_dim: int = 128,
               rope_base: float = 10000.0):
    """Absorbed single-token decode. x: (B, 1, D); cache_ckv (B, Smax,
    kv_lora) and cache_kpe (B, Smax, qk_rope), written in place at
    ``pos`` (an int or a one-element int64 tensor). Returns (out,
    cache_ckv, cache_kpe)."""
    dev = x.device
    pos = torch.as_tensor(pos, dtype=torch.long, device=dev).reshape(1)
    q_nope, q_pe, c_kv_new, k_pe_new = _project(
        p, x, pos, qk_nope=qk_nope, qk_rope=qk_rope, kv_lora=kv_lora,
        rope_base=rope_base)
    masked_cache_update(cache_ckv, c_kv_new, pos, axis=1)
    masked_cache_update(cache_kpe, k_pe_new[:, :, 0, :], pos, axis=1)

    # absorb q_nope through W_uk: (B,1,H,nope) x (lora,H,nope) -> latent q
    q_lat = heads_einsum("bshk,lhk->bshl", q_nope, p["w_uk"])
    ckv = cache_ckv.float()
    s = (heads_einsum("bshl,btl->bhst", q_lat.float(), ckv)
         + heads_einsum("bshk,btk->bhst", q_pe.float(), cache_kpe.float()))
    s = s * (1.0 / math.sqrt(qk_nope + qk_rope))
    t = torch.arange(cache_ckv.shape[1], device=dev)
    s = torch.where(t <= pos, s, -math.inf)
    a = torch.softmax(s, dim=-1)
    ctx = heads_einsum("bhst,btl->bshl", a, ckv).to(x.dtype)
    out = heads_einsum("bshl,lhk->bshk", ctx, p["w_uv"])    # un-absorb W_uv
    out = heads_einsum("bshk,hkd->bsd", out, p["w_o"])
    return out, cache_ckv, cache_kpe
