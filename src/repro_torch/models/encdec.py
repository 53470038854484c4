"""Encoder-decoder assembly (seamless-m4t-medium's backbone), in PyTorch
(the port of ``repro.models.encdec``).

The modality frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, T_enc, d_model). Encoder layers are
non-causal self-attention + MLP; decoder layers are causal
self-attention, cross-attention over the encoder output, then MLP.
Serving has no decoder prefill: the cross-attention KV of every decoder
layer is computed once from the encoder output (``fill_cross_cache``),
then ``encdec_decode_step`` decodes one token at a time from position 0,
its self-attention KV growing in the cache and its cross-attention
scored in float32 against the static encoder KV. Training
differentiates ``encdec_forward``; with ``cfg.remat`` each encoder and
decoder layer recomputes its activations in the backward, as the
reference's ``jax.checkpoint`` over its scan bodies does. ``mesh=`` runs
the same code on DTensors, as ``lm.py`` does: every layer's input
pinned over the batch axes, the logits batch x vocab sharded, and the
serving cache placed by ``encdec_cache_axes``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from .. import sharding as SH
from . import layers as L
from .layers import PSpec
from .lm import ArchCfg, _constrain_act, _logits, _norm, remat, unstack

__all__ = ["encdec_spec", "encode", "decode_train", "encdec_forward",
           "encdec_decode_step", "init_encdec_cache", "abstract_encdec_cache",
           "encdec_cache_axes", "fill_cross_cache"]


def _norm_spec(cfg: ArchCfg, stack):
    st = (stack,) if stack else ()
    pre = "stack," if stack else ""
    return PSpec(st + (cfg.d_model,), pre + ".", init="ones")


def _block(cfg: ArchCfg, stack: int, *, cross: bool) -> Dict[str, Any]:
    s = {
        "mix_norm": _norm_spec(cfg, stack),
        "attn": L.attn_spec(cfg.d_model, cfg.n_heads, cfg.n_kv,
                            cfg.head_dim, stack=stack),
        "ffn_norm": _norm_spec(cfg, stack),
        "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, gated=False, stack=stack),
    }
    if cross:
        s["cross_norm"] = _norm_spec(cfg, stack)
        s["cross"] = L.attn_spec(cfg.d_model, cfg.n_heads, cfg.n_kv,
                                 cfg.head_dim, stack=stack)
    return s


def encdec_spec(cfg: ArchCfg, n_enc: int, n_dec: int) -> Dict[str, Any]:
    return {
        "embed": L.embed_spec(cfg.vocab_padded, cfg.d_model),
        "enc": _block(cfg, n_enc, cross=False),
        "enc_norm": _norm_spec(cfg, None),
        "dec": _block(cfg, n_dec, cross=True),
        "final_norm": _norm_spec(cfg, None),
    }


# ---------------------------------------------------------------------------

def _cross_full(p, x, enc_kv, cfg):
    """Full-sequence cross attention (no rope, no mask). enc_kv: (k, v),
    each (B, T, Hkv, hd)."""
    q = L.heads_einsum("bsd,dhk->bshk", x, p["wq"])
    k, v = enc_kv
    out = L.blockwise_attention(q, k, v, causal=False, q_chunk=cfg.q_chunk,
                                kv_chunk=cfg.kv_chunk)
    return L.heads_einsum("bshk,hkd->bsd", out, p["wo"])


def _cross_kv(p, enc_out):
    k = L.heads_einsum("bsd,dhk->bshk", enc_out, p["wk"])
    v = L.heads_einsum("bsd,dhk->bshk", enc_out, p["wv"])
    return k, v


def encode(params, frames, cfg: ArchCfg, mesh=None):
    """frames: (B, T, d_model) stub embeddings -> the encoder's output.
    ``mesh``: as ``lm.lm_forward``'s (``frames`` placed over the batch
    axes)."""
    with SH.on_mesh(mesh):
        x = SH.constrain(frames, mesh, ("batch", None, None))
        for p in unstack(params["enc"], cfg.n_enc):
            x = remat(cfg, _enc_layer, x, p, cfg, mesh)
        return L.rmsnorm(x, params["enc_norm"])


def _enc_layer(x, p, cfg: ArchCfg, mesh=None):
    x = L.grad_cast_bf16(_constrain_act(x, mesh, cfg))
    h, _ = L.gqa_full(p["attn"], _norm(cfg, x, p["mix_norm"]),
                      rope_base=10000.0, causal=False,
                      q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    x = SH.settle(x + h)
    return SH.settle(x + L.mlp_apply(p["mlp"], _norm(cfg, x, p["ffn_norm"]),
                                     act="gelu"))


def _dec_layer(x, p, enc_out, cfg: ArchCfg, mesh=None):
    x = L.grad_cast_bf16(_constrain_act(x, mesh, cfg))
    h, _ = L.gqa_full(p["attn"], _norm(cfg, x, p["mix_norm"]),
                      rope_base=10000.0, causal=True,
                      q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    x = SH.settle(x + h)
    x = SH.settle(x + _cross_full(p["cross"], _norm(cfg, x, p["cross_norm"]),
                                  _cross_kv(p["cross"], enc_out), cfg))
    return SH.settle(x + L.mlp_apply(p["mlp"], _norm(cfg, x, p["ffn_norm"]),
                                     act="gelu"))


def decode_train(params, enc_out, tokens, cfg: ArchCfg, mesh=None,
                 last_only: bool = False):
    """Teacher-forced decoder over tokens (B, S): float32 logits (B, S,
    V), or (B, 1, V) with ``last_only``."""
    with SH.on_mesh(mesh):
        tokens = SH.constrain(tokens, mesh, ("batch", None))
        x = L.embed_apply(params["embed"], tokens, scale=cfg.embed_scale)
        for p in unstack(params["dec"], cfg.n_dec):
            x = remat(cfg, _dec_layer, x, p, enc_out, cfg, mesh)
        if last_only:
            x = x[:, -1:]
        x = _norm(cfg, x, params["final_norm"])
        return _logits(params, x, cfg, mesh)


def encdec_forward(params, frames, tokens, cfg: ArchCfg, mesh=None):
    return decode_train(params, encode(params, frames, cfg, mesh), tokens,
                        cfg, mesh=mesh)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _cache_shapes(cfg: ArchCfg, n_dec: int, batch: int, max_len: int,
                  enc_len: int):
    kv = (batch, max_len, cfg.n_kv, cfg.head_dim)
    xkv = (batch, enc_len, cfg.n_kv, cfg.head_dim)
    return {
        "self_k": ((n_dec,) + kv, torch.bfloat16),
        "self_v": ((n_dec,) + kv, torch.bfloat16),
        "cross_k": ((n_dec,) + xkv, torch.bfloat16),
        "cross_v": ((n_dec,) + xkv, torch.bfloat16),
    }


def init_encdec_cache(cfg, n_dec, batch, max_len, enc_len, *, device):
    """Zeroed bf16 buffers: the decoder's self-attention KV at
    ``max_len`` and the cross-attention KV at ``enc_len``, stacked over
    the ``n_dec`` layers."""
    return {k: torch.zeros(sh, dtype=dt, device=device) for k, (sh, dt) in
            _cache_shapes(cfg, n_dec, batch, max_len, enc_len).items()}


def abstract_encdec_cache(cfg, n_dec, batch, max_len, enc_len):
    """The cache's ``meta`` tensors: no allocation."""
    return {k: torch.empty(sh, dtype=dt, device="meta") for k, (sh, dt) in
            _cache_shapes(cfg, n_dec, batch, max_len, enc_len).items()}


def fill_cross_cache(params, enc_out, cache, cfg: ArchCfg):
    """Compute the static cross-attention KV of every decoder layer into
    ``cache`` (in place, cast to its dtype); returns ``cache``."""
    for i, p in enumerate(unstack(params["dec"], cfg.n_dec)):
        k, v = _cross_kv(p["cross"], enc_out)
        for buf, new in ((cache["cross_k"][i], k), (cache["cross_v"][i], v)):
            if SH.is_dtensor(buf):
                SH.paste(buf, new)      # each rank into its own block
            else:
                buf.copy_(new)
    return cache


def encdec_cache_axes(cfg, n_dec, batch, max_len, enc_len):
    """Logical sharding axes of the cache: batch over data, the KV
    sequence over model."""
    return {k: "stack,batch,kv_seq_model,.,." for k in
            _cache_shapes(cfg, n_dec, batch, max_len, enc_len)}


def encdec_decode_step(params, cache, tokens, pos, cfg: ArchCfg,
                       mesh=None):
    """One decoder token. tokens: (B, 1); pos: an int or a one-element
    int64 tensor. Writes the self-attention k/v into ``cache`` in place
    and returns (logits (B, 1, V) float32, cache). ``mesh``: as
    ``lm.lm_decode_step``'s (the cache placed by ``encdec_cache_axes``)."""
    with SH.on_mesh(mesh):
        tokens = SH.constrain(tokens, mesh, ("batch", None))
        return _decode_step(params, cache, tokens, pos, cfg, mesh)


def _decode_step(params, cache, tokens, pos, cfg, mesh):
    x = L.embed_apply(params["embed"], tokens, scale=cfg.embed_scale)
    pos = torch.as_tensor(pos, dtype=torch.long, device=x.device).reshape(1)
    for i, p in enumerate(unstack(params["dec"], cfg.n_dec)):
        h, _, _ = L.gqa_decode(p["attn"], _norm(cfg, x, p["mix_norm"]),
                               cache["self_k"][i], cache["self_v"][i], pos,
                               rope_base=10000.0)
        x = SH.settle(x + h)
        # cross attention against the static encoder KV, in float32
        xk, xv = cache["cross_k"][i], cache["cross_v"][i]
        xn = _norm(cfg, x, p["cross_norm"])
        q = L.heads_einsum("bsd,dhk->bshk", xn, p["cross"]["wq"])
        B, _, H, hd = q.shape
        Hkv = xk.shape[2]
        qg = q.reshape(B, Hkv, H // Hkv, hd)
        s = L.heads_einsum("bhgk,bthk->bhgt", qg.float(), xk.float())
        a = torch.softmax(s / math.sqrt(hd), dim=-1)
        o = L.heads_einsum("bhgt,bthk->bhgk", a, xv.float()).to(x.dtype)
        o = o.reshape(B, 1, H, hd)
        x = SH.settle(x + L.heads_einsum("bshk,hkd->bsd", o,
                                         p["cross"]["wo"]))
        x = SH.settle(x + L.mlp_apply(p["mlp"], _norm(cfg, x, p["ffn_norm"]),
                                      act="gelu"))
    x = _norm(cfg, x, params["final_norm"])
    return _logits(params, x, cfg, mesh), cache
