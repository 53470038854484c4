"""Decoder-only LM assembly, in PyTorch (the port of ``repro.models.lm``).

A model is a sequence of *blocks* described by :class:`LayerKind`
(temporal mixer + channel mixer): a repeating ``block_pattern`` with
params stacked on a leading ``(repeats, ...)`` axis, plus an optional
non-repeating ``tail``. The parameter tree keeps the reference's keys and
layout, so the JAX package's params convert key for key
(``repro_torch.convert.lm_params_from_numpy``).

Every family of the reference serves here: dense GQA (with post-norms,
sliding windows, per-kind ``rope_base``, logit softcaps, padded
vocabularies and the VLM prefix), MLA (``models/mla.py``), MoE FFNs
(``models/moe.py``), xLSTM's mLSTM and sLSTM (``models/ssm.py``) and
RG-LRU (``models/rglru.py``). The encoder-decoder family assembles the
same blocks in ``models/encdec.py``; run through this module, an
enc-dec config is its decoder stack alone, as in the reference.

With ``mesh=`` (a ``DeviceMesh``; ``repro_torch.sharding``) the same code
runs on DTensors: params placed by ``sharding.param_sharding_rules``,
tokens and caches by the batch axes and ``cache_axes``, the activations
pinned at block boundaries as the reference's ``with_sharding_constraint``
pins them (``_constrain_act``), the logits kept batch x vocab sharded, and
the MoE layers expert-parallel over "model" (``models/moe.py``). Without
a mesh nothing of that runs. Training (``repro_torch.train``)
differentiates ``lm_forward`` with autograd; with ``cfg.remat`` each
repeat of the block pattern recomputes its activations in the backward,
as the reference's ``jax.checkpoint`` over its scan body does.

The functional core (``lm_forward``, ``lm_decode_step``) takes the nested
dict of tensors; :class:`LanguageModel` is the ``nn.Module`` that holds
that tree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import sharding as SH
from ..core.engine import resolve_device
from . import layers as L
from . import mla as MLA
from . import moe as MOE
from . import rglru as RG
from . import ssm as SSM
from .layers import PSpec

__all__ = ["LayerKind", "MoeCfg", "MlaCfg", "ArchCfg", "LanguageModel",
           "check_device", "block_spec", "lm_spec",
           "num_params", "lm_forward", "lm_decode_step", "init_cache",
           "abstract_cache", "cache_axes", "place_cache", "remat",
           "unstack"]


@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: str = "attn"          # attn | mla | mlstm | slstm | rglru
    ffn: str = "mlp"             # mlp | moe | none
    window: Optional[int] = None  # sliding window for attn
    rope_base: float = 10000.0


@dataclasses.dataclass(frozen=True)
class MoeCfg:
    n_routed: int
    n_shared: int
    topk: int
    d_ff_expert: int
    renormalize: bool = True
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MlaCfg:
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ArchCfg:
    name: str
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    block_pattern: Tuple[LayerKind, ...]
    repeats: int
    tail: Tuple[LayerKind, ...] = ()
    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    act: str = "silu"            # mlp activation: silu | gelu | relu2
    logit_cap: Optional[float] = None
    # norms / embeddings
    norm_plus_one: bool = False  # gemma-style (1 + w) RMSNorm, zero-init
    post_norms: bool = False     # gemma-style sandwich norms
    embed_scale: bool = False
    tie_embeddings: bool = True
    # family extras
    moe: Optional[MoeCfg] = None
    mla: Optional[MlaCfg] = None
    xlstm_heads: int = 4
    lru_width: Optional[int] = None
    prefix_len: int = 0          # VLM / multimodal stub prefix tokens
    # family plumbing
    family: str = "lm"           # lm | encdec | vlm
    n_enc: int = 0               # encoder layers (encdec only)
    n_dec: int = 0               # decoder layers (encdec only)
    # runtime
    q_chunk: int = 512
    kv_chunk: int = 1024
    remat: bool = True
    long_context_ok: bool = False  # sub-quadratic: eligible for long_500k
    # embedding/logits table padding (padded ids masked from the softmax)
    vocab_pad_to: int = 0
    # the reference's training and sharding levers; serving reads
    # attn_block_skip only
    accum_bf16: bool = False
    attn_block_skip: bool = False
    seq_shard_acts: bool = False
    scan_unroll: bool = False

    @property
    def n_layers(self) -> int:
        return len(self.block_pattern) * self.repeats + len(self.tail)

    @property
    def vocab_padded(self) -> int:
        if not self.vocab_pad_to:
            return self.vocab
        m = self.vocab_pad_to
        return -(-self.vocab // m) * m


def check_device(what: str, have: torch.device,
                 device: torch.device) -> None:
    """Raise unless ``have`` is ``device``; ``what`` names what lies on
    ``have`` ("params lie")."""
    if have.type != device.type or (device.index is not None
                                    and have.index != device.index):
        raise ValueError(f"{what} on {have}, not on the serving device "
                         f"{device}: move it there first")


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------

def _norm_spec(cfg: ArchCfg, stack):
    st = (stack,) if stack else ()
    pre = "stack," if stack else ""
    init = "zeros" if cfg.norm_plus_one else "ones"
    return PSpec(st + (cfg.d_model,), pre + ".", init=init)


def block_spec(kind: LayerKind, cfg: ArchCfg,
               stack: Optional[int] = None) -> Dict[str, Any]:
    s: Dict[str, Any] = {}
    if kind.mixer == "attn":
        s["mix_norm"] = _norm_spec(cfg, stack)
        s["attn"] = L.attn_spec(cfg.d_model, cfg.n_heads, cfg.n_kv,
                                cfg.head_dim, qkv_bias=cfg.qkv_bias,
                                qk_norm=cfg.qk_norm, stack=stack)
    elif kind.mixer == "mla":
        s["mix_norm"] = _norm_spec(cfg, stack)
        m = cfg.mla
        s["attn"] = MLA.mla_spec(cfg.d_model, cfg.n_heads, q_lora=m.q_lora,
                                 kv_lora=m.kv_lora, qk_nope=m.qk_nope,
                                 qk_rope=m.qk_rope, v_dim=m.v_dim,
                                 stack=stack)
    elif kind.mixer == "mlstm":
        s["mlstm"] = SSM.mlstm_spec(cfg.d_model, cfg.xlstm_heads,
                                    stack=stack)
    elif kind.mixer == "slstm":
        s["slstm"] = SSM.slstm_spec(cfg.d_model, cfg.xlstm_heads,
                                    stack=stack)
    elif kind.mixer == "rglru":
        s["rglru"] = RG.rglru_spec(cfg.d_model, lru_width=cfg.lru_width,
                                   stack=stack)
    else:
        raise ValueError(kind.mixer)

    if cfg.post_norms and kind.mixer in ("attn", "mla"):
        s["mix_post_norm"] = _norm_spec(cfg, stack)

    if kind.ffn == "mlp":
        s["ffn_norm"] = _norm_spec(cfg, stack)
        s["mlp"] = L.mlp_spec(cfg.d_model, cfg.d_ff,
                              gated=cfg.act in ("silu", "gelu"),
                              stack=stack)
        if cfg.post_norms:
            s["ffn_post_norm"] = _norm_spec(cfg, stack)
    elif kind.ffn == "moe":
        mo = cfg.moe
        s["ffn_norm"] = _norm_spec(cfg, stack)
        s["moe"] = MOE.moe_spec(cfg.d_model, mo.d_ff_expert, mo.n_routed,
                                mo.n_shared, stack=stack)
    return s


def lm_spec(cfg: ArchCfg) -> Dict[str, Any]:
    s: Dict[str, Any] = {
        "embed": L.embed_spec(cfg.vocab_padded, cfg.d_model),
        "final_norm": _norm_spec(cfg, None),
        "stage": {str(i): block_spec(k, cfg, stack=cfg.repeats)
                  for i, k in enumerate(cfg.block_pattern)},
    }
    if cfg.tail:
        s["tail"] = {str(i): block_spec(k, cfg, stack=None)
                     for i, k in enumerate(cfg.tail)}
    if not cfg.tie_embeddings:
        s["lm_head"] = PSpec((cfg.d_model, cfg.vocab_padded), ".,vocab",
                             fan_in=cfg.d_model)
    return s


def num_params(cfg: ArchCfg) -> int:
    return L.param_count(lm_spec(cfg))


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _norm(cfg, x, w):
    return L.rmsnorm(x, w, plus_one=cfg.norm_plus_one)


def _constrain_act(x, mesh, cfg=None):
    """Pin activations to (batch over data(+pod), seq/feature replicated)
    at block boundaries, as the reference does against SPMD propagation.
    With ``cfg.seq_shard_acts`` (sequence parallelism) the boundary
    activations are also sharded over "model" on the sequence axis. A
    redistribute of the DTensor; without a mesh, ``x`` as it is."""
    if mesh is None:
        return x
    seq = "seq_model" if (cfg is not None and cfg.seq_shard_acts
                          and x.ndim == 3) else None
    logical = (("batch", seq) + (None,) * (x.ndim - 2) if x.ndim >= 2
               else ("batch",))
    return SH.constrain(x, mesh, logical)


def _moe_capacity(cfg: ArchCfg, n_tokens_local: int) -> int:
    """Slots per expert for ``n_tokens_local`` tokens (one data shard's):
    capacity_factor times the mean load, at least 8, rounded up to a
    multiple of 8."""
    mo = cfg.moe
    c = math.ceil(n_tokens_local * mo.topk * mo.capacity_factor
                  / mo.n_routed)
    return max(8, -(-c // 8) * 8)


def _apply_ffn(kind, p, x, cfg, mesh=None):
    if kind.ffn == "mlp":
        h = L.mlp_apply(p["mlp"], _norm(cfg, x, p["ffn_norm"]), act=cfg.act)
        if cfg.post_norms:
            h = _norm(cfg, h, p["ffn_post_norm"])
        return x + L.grad_cast_bf16(h)
    if kind.ffn == "moe":
        B, S, _ = x.shape
        dp = 1
        if mesh is not None:
            dp = SH.axis_size(mesh, SH.batch_axes(mesh))
        cap = _moe_capacity(cfg, max(1, (B * S) // dp))
        h = MOE.moe_apply(p["moe"], _norm(cfg, x, p["ffn_norm"]),
                          topk=cfg.moe.topk, n_routed=cfg.moe.n_routed,
                          capacity=cap, renormalize=cfg.moe.renormalize,
                          mesh=mesh)
        return x + h
    return x


def block_full(kind: LayerKind, p, x, cfg: ArchCfg, mesh=None):
    """Prefill through one block. Returns (x, cache_entry): k/v, the MLA
    latents, or a recurrent mixer's state after the last position. On a
    mesh the residual stream is settled (``sharding.settle``) on entry,
    after the mixer and on exit."""
    x = SH.settle(x)
    if kind.mixer == "attn":
        h, (k, v) = L.gqa_full(
            p["attn"], _norm(cfg, x, p["mix_norm"]),
            rope_base=kind.rope_base, window=kind.window,
            qk_norm=cfg.qk_norm, logit_cap=cfg.logit_cap,
            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
            skip_masked_blocks=cfg.attn_block_skip)
        if cfg.post_norms:
            h = _norm(cfg, h, p["mix_post_norm"])
        x = x + L.grad_cast_bf16(h)
        cache = {"k": k, "v": v}
    elif kind.mixer == "mla":
        m = cfg.mla
        h, (ckv, kpe) = MLA.mla_full(
            p["attn"], _norm(cfg, x, p["mix_norm"]), qk_nope=m.qk_nope,
            qk_rope=m.qk_rope, kv_lora=m.kv_lora, v_dim=m.v_dim,
            rope_base=kind.rope_base, q_chunk=cfg.q_chunk,
            kv_chunk=cfg.kv_chunk)
        x = x + L.grad_cast_bf16(h)
        cache = {"ckv": ckv, "kpe": kpe}
    elif kind.mixer == "mlstm":
        h, cache = SSM.mlstm_scan(p["mlstm"], x, n_heads=cfg.xlstm_heads)
        x = x + h
    elif kind.mixer == "slstm":
        h, cache = SSM.slstm_scan(p["slstm"], x, n_heads=cfg.xlstm_heads)
        x = x + h
    elif kind.mixer == "rglru":
        h, cache = RG.rglru_scan(p["rglru"], x)
        x = x + h
    else:
        raise ValueError(kind.mixer)
    x = SH.settle(x)
    return SH.settle(_apply_ffn(kind, p, x, cfg, mesh)), cache


def block_decode(kind: LayerKind, p, x, cache, pos, cfg: ArchCfg,
                 mesh=None):
    """Single-token decode through one block. Attention k/v and MLA
    latents are written into ``cache`` in place at ``pos``; a recurrent
    mixer returns its new state. Returns (x, the layer's new cache
    entry). On a mesh the residual stream is settled as in
    ``block_full``."""
    x = SH.settle(x)
    if kind.mixer == "attn":
        h, ck, cv = L.gqa_decode(
            p["attn"], _norm(cfg, x, p["mix_norm"]), cache["k"],
            cache["v"], pos, rope_base=kind.rope_base, window=kind.window,
            qk_norm=cfg.qk_norm, logit_cap=cfg.logit_cap)
        if cfg.post_norms:
            h = _norm(cfg, h, p["mix_post_norm"])
        x = x + h
        cache = {"k": ck, "v": cv}
    elif kind.mixer == "mla":
        m = cfg.mla
        h, ckv, kpe = MLA.mla_decode(
            p["attn"], _norm(cfg, x, p["mix_norm"]), cache["ckv"],
            cache["kpe"], pos, qk_nope=m.qk_nope, qk_rope=m.qk_rope,
            kv_lora=m.kv_lora, v_dim=m.v_dim, rope_base=kind.rope_base)
        x = x + L.grad_cast_bf16(h)
        cache = {"ckv": ckv, "kpe": kpe}
    elif kind.mixer == "mlstm":
        h, cache = SSM.mlstm_step(p["mlstm"], x, cache,
                                  n_heads=cfg.xlstm_heads)
        x = x + h
    elif kind.mixer == "slstm":
        h, cache = SSM.slstm_step(p["slstm"], x, cache,
                                  n_heads=cfg.xlstm_heads)
        x = x + h
    elif kind.mixer == "rglru":
        h, cache = RG.rglru_step(p["rglru"], x, cache)
        x = x + h
    else:
        raise ValueError(kind.mixer)
    x = SH.settle(x)
    return SH.settle(_apply_ffn(kind, p, x, cfg, mesh)), cache


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _block_cache_shapes(kind: LayerKind, cfg: ArchCfg, batch: int,
                        max_len: int):
    d = cfg.d_model
    if kind.mixer == "attn":
        sh = (batch, max_len, cfg.n_kv, cfg.head_dim)
        return {"k": (sh, torch.bfloat16), "v": (sh, torch.bfloat16)}
    if kind.mixer == "mla":
        m = cfg.mla
        return {"ckv": ((batch, max_len, m.kv_lora), torch.bfloat16),
                "kpe": ((batch, max_len, m.qk_rope), torch.bfloat16)}
    if kind.mixer == "mlstm":
        di = int(d * 2.0)
        dh = di // cfg.xlstm_heads
        return {"C": ((batch, cfg.xlstm_heads, dh, dh), torch.float32),
                "n": ((batch, cfg.xlstm_heads, dh), torch.float32),
                "m": ((batch, cfg.xlstm_heads), torch.float32),
                "conv": ((batch, SSM.CONV_W - 1, di), torch.bfloat16)}
    if kind.mixer == "slstm":
        sh = (batch, d)
        return {"c": (sh, torch.float32), "n": (sh, torch.float32),
                "h": (sh, torch.float32), "m": (sh, torch.float32)}
    if kind.mixer == "rglru":
        dr = cfg.lru_width or d
        return {"h": ((batch, dr), torch.float32),
                "conv": ((batch, SSM.CONV_W - 1, dr), torch.bfloat16)}
    raise ValueError(kind.mixer)


def _make_cache(cfg: ArchCfg, batch: int, max_len: int, fn):
    """fn(name, shape, dtype) -> leaf; stage leaves get the (repeats,)
    axis in front."""
    out = {"stage": {}}
    for i, kind in enumerate(cfg.block_pattern):
        shapes = _block_cache_shapes(kind, cfg, batch, max_len)
        out["stage"][str(i)] = {
            k: fn(k, (cfg.repeats,) + sh, dt)
            for k, (sh, dt) in shapes.items()}
    if cfg.tail:
        out["tail"] = {}
        for i, kind in enumerate(cfg.tail):
            shapes = _block_cache_shapes(kind, cfg, batch, max_len)
            out["tail"][str(i)] = {
                k: fn(k, sh, dt) for k, (sh, dt) in shapes.items()}
    return out


def init_cache(cfg: ArchCfg, batch: int, max_len: int, *, device):
    """The serving buffers: KV and MLA latents at ``max_len`` (bf16),
    recurrent states (float32, conv buffers bf16), every leaf zero but
    the float32 ``m`` stabilizers of rank <= 3, which start at -inf (the
    reference's rule)."""
    def mk(name, sh, dt):
        if name == "m" and dt == torch.float32 and len(sh) <= 3:
            return torch.full(sh, -math.inf, dtype=dt, device=device)
        return torch.zeros(sh, dtype=dt, device=device)
    return _make_cache(cfg, batch, max_len, mk)


def abstract_cache(cfg: ArchCfg, batch: int, max_len: int):
    """The cache's ``meta`` tensors: no allocation."""
    return _make_cache(cfg, batch, max_len, lambda name, sh, dt: torch.empty(
        sh, dtype=dt, device="meta"))


def cache_axes(cfg: ArchCfg, batch: int, max_len: int):
    """Logical sharding axes matching the cache tree: batch over data,
    the KV sequence over model (flash-decoding split); the stack axis of
    a stage leaf unsharded."""
    def axes(sh):
        if len(sh) >= 2 and sh[1] == max_len:
            return ["batch", "kv_seq_model"] + ["."] * (len(sh) - 2)
        return ["batch"] + ["."] * (len(sh) - 1)

    def mk(stacked):
        return lambda name, sh, dt: ",".join(
            ["stack"] + axes(sh[1:]) if stacked else axes(sh))
    out = _make_cache(cfg, batch, max_len, mk(True))
    if cfg.tail:
        out["tail"] = _make_cache(cfg, batch, max_len, mk(False))["tail"]
    return out


def place_cache(cache, cfg: ArchCfg, mesh, *, batch: int, max_len: int):
    """``cache`` (``init_cache``'s tree) placed on ``mesh`` by
    ``cache_axes``."""
    specs = SH.param_sharding_rules(mesh, cache,
                                    cache_axes(cfg, batch, max_len))
    return SH.place_tree(mesh, cache, specs)


# ---------------------------------------------------------------------------
# forward / decode
# ---------------------------------------------------------------------------

def unstack(stack_tree, n: int):
    """Each of the ``n`` layers' views of a stacked (n, ...) tree, from one
    ``unbind`` per leaf: a backward then stacks each leaf's gradient once,
    where indexing layer by layer would add ``n`` zero-filled copies of the
    whole stack."""
    per_leaf = L.tree_map(lambda a: a.unbind(0), stack_tree)
    return [L.tree_map(lambda t: t[i], per_leaf) for i in range(n)]


def remat(cfg, fn, *args):
    """``fn(*args)``, its activations recomputed in the backward
    (``jax.checkpoint``'s counterpart) when ``cfg.remat`` is set and grad
    is on; serving under ``no_grad`` runs ``fn`` as it is."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _stage(x, layer, cfg: ArchCfg, mesh=None):
    """One repeat of the block pattern: (x, each block's cache entry)."""
    x = L.grad_cast_bf16(_constrain_act(x, mesh, cfg))
    caches = []
    for i, kind in enumerate(cfg.block_pattern):
        x, c = block_full(kind, layer[str(i)], x, cfg, mesh)
        caches.append(c)
    return _constrain_act(x, mesh, cfg), caches


def lm_forward(params, tokens, cfg: ArchCfg, *, mesh=None,
               prefix_embeds=None, return_cache: bool = False,
               last_only: bool = False):
    """tokens: (B, S) int64 tensor. prefix_embeds: optional (B, Sp, D)
    stub prefix (VLM), placed before the tokens. Returns float32 logits
    (B, S_total, V), or (B, 1, V) with ``last_only``, and with
    ``return_cache`` the prefill KV caches: stacked (repeats, B, S_total,
    Hkv, hd) per stage block, k roped, not padded to a max_len, and each
    recurrent mixer's state after the last position.

    ``mesh``: a ``DeviceMesh``; params are DTensors placed by the rules,
    tokens and the prefix are placed over the batch axes (a plain tensor
    is taken as the whole batch), and the results are DTensors."""
    with SH.on_mesh(mesh):
        return _forward(params, tokens, cfg, mesh, prefix_embeds,
                        return_cache, last_only)


def _forward(params, tokens, cfg, mesh, prefix_embeds, return_cache,
             last_only):
    if mesh is not None:
        tokens = SH.constrain(tokens, mesh, ("batch", None))
        if prefix_embeds is not None:
            prefix_embeds = SH.constrain(prefix_embeds, mesh,
                                         ("batch", None, None))
    x = L.embed_apply(params["embed"], tokens, scale=cfg.embed_scale)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)

    stage_caches = [dict() for _ in cfg.block_pattern]
    for layer in unstack(params["stage"], cfg.repeats):
        x, cs = remat(cfg, _stage, x, layer, cfg, mesh)
        if return_cache:
            for i, c in enumerate(cs):
                for name, t in c.items():
                    stage_caches[i].setdefault(name, []).append(t)
    caches = None
    if return_cache:
        caches = {"stage": {str(i): {k: torch.stack(ts) for k, ts in
                                     c.items()}
                            for i, c in enumerate(stage_caches)}}

    if cfg.tail:
        if return_cache:
            caches["tail"] = {}
        for i, kind in enumerate(cfg.tail):
            x, c = block_full(kind, params["tail"][str(i)], x, cfg, mesh)
            if return_cache:
                caches["tail"][str(i)] = c

    if last_only:
        x = x[:, -1:]  # serve prefill: only the last position's logits
    x = _norm(cfg, x, params["final_norm"])
    logits = _logits(params, x, cfg, mesh)
    return (logits, caches) if return_cache else logits


def _logits(params, x, cfg: ArchCfg, mesh=None):
    if cfg.tie_embeddings:
        logits = L.logits_apply(params["embed"], x, transpose=True,
                                cap=cfg.logit_cap)
    else:
        logits = L.logits_apply(params["lm_head"], x, transpose=False,
                                cap=cfg.logit_cap)
    if cfg.vocab_padded != cfg.vocab:
        # mask padding ids out of the softmax
        vid = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(vid < cfg.vocab, logits, -1e9)
    # on a mesh: batch over data, vocab over model, never replicated
    return SH.constrain(logits, mesh, ("batch", None, "vocab"))


def _write_back(buffers, new) -> None:
    """Copy a layer's new cache entry into its buffers (views of the
    cache), leaf by leaf, where the mixer did not write in place: a
    recurrent state replaces the old one, as the reference's stacked
    update does."""
    for name, t in new.items():
        buf = buffers[name]
        if t is buf:
            continue
        if SH.is_dtensor(buf):
            t = t.redistribute(buf.device_mesh, buf.placements)
        buf.copy_(t)


def lm_decode_step(params, cache, tokens, pos, cfg: ArchCfg, *,
                   mesh=None):
    """tokens: (B, 1) int64; pos: the position written (an int or a 0-d or
    one-element int tensor on the params' device). Updates ``cache`` in
    place (the reference donates its cache): every layer's new k/v or MLA
    latents at ``pos``, every recurrent state replaced. Returns (logits
    (B, 1, V) float32, cache). ``mesh``: as ``lm_forward``; the cache is
    placed by ``cache_axes`` (``place_cache``)."""
    with SH.on_mesh(mesh):
        if mesh is not None:
            tokens = SH.constrain(tokens, mesh, ("batch", None))
        x = L.embed_apply(params["embed"], tokens, scale=cfg.embed_scale)
        pos = torch.as_tensor(pos, dtype=torch.long,
                              device=x.device).reshape(1)
        for p_r, c_r in zip(unstack(params["stage"], cfg.repeats),
                            unstack(cache["stage"], cfg.repeats)):
            x = _constrain_act(x, mesh)
            for j, kind in enumerate(cfg.block_pattern):
                x, new = block_decode(kind, p_r[str(j)], x, c_r[str(j)],
                                      pos, cfg, mesh)
                _write_back(c_r[str(j)], new)
        for i, kind in enumerate(cfg.tail):
            x, new = block_decode(kind, params["tail"][str(i)], x,
                                  cache["tail"][str(i)], pos, cfg, mesh)
            _write_back(cache["tail"][str(i)], new)
        x = _norm(cfg, x, params["final_norm"])
        return _logits(params, x, cfg, mesh), cache


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

class _Tree(nn.Module):
    """A nested dict of tensors as a module tree (frozen parameters)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    def tree(self) -> Dict[str, Any]:
        out = {k: m.tree() for k, m in self.named_children()}
        out.update(self.named_parameters(recurse=False))
        return out


class LanguageModel(nn.Module):
    """The parameter tree of ``cfg`` as an ``nn.Module`` over the
    functional core. ``params`` is a tree of the reference's keys and
    layout (from ``convert.lm_params_from_numpy``), or None for a random
    init from ``generator`` (``layers.init_params``). Runs on the card
    unless ``device="cpu"`` is asked for; ``params`` and ``generator``
    must lie on that device."""

    def __init__(self, cfg: ArchCfg, params: Optional[Dict[str, Any]] = None,
                 *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        if params is None and generator is None:
            raise ValueError("give params or a generator")
        self.device = resolve_device(device)
        if params is None:
            check_device("the generator lies", generator.device, self.device)
            params = L.init_params(lm_spec(cfg), generator=generator)
        check_device("params lie", params["embed"].device, self.device)
        self.cfg = cfg
        self.weights = _Tree(params)

    @property
    def params(self) -> Dict[str, Any]:
        return self.weights.tree()

    def forward(self, tokens, *, prefix_embeds=None,
                return_cache: bool = False, last_only: bool = False):
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        return lm_forward(self.params, tokens, self.cfg,
                          prefix_embeds=prefix_embeds,
                          return_cache=return_cache, last_only=last_only)
