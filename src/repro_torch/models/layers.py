"""Shared layer library of the LM substrate, in PyTorch.

The port of ``repro.models.layers``: functional, module-free, every layer
a (spec, apply) pair. ``spec`` returns a nested dict of :class:`PSpec`
leaves (shape, dtype, logical sharding axes, initializer); generic
walkers turn a spec tree into real tensors (``init_params``, from an
explicit ``torch.Generator``), ``meta`` stand-ins that allocate nothing
(``abstract_params``), the axes tree (``axes_tree``) or a count
(``param_count``).

Compute policy, as the reference's: params bf16, matmuls in the model
dtype, softmax, norms and logits in float32. Attention is blockwise
(flash-style: a loop over KV chunks with a float32 running max and sum),
so a long prefill never holds an S x S score matrix. A product the
reference asks in float32 of bf16 operands (``preferred_element_type``)
is taken on the operands cast to float32: the products of bf16 values
are exact in float32 and the sum is a float32 one, as the reference's.

On a mesh the same functions run on DTensors (``repro_torch.sharding``).
``masked_cache_update`` writes the new entry in place at ``pos`` (the
reference's iota == pos select gives the same values without a dynamic
index on a sharded axis); into a DTensor cache each rank writes its own
block (``sharding.write_at``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import sharding as SH

__all__ = [
    "PSpec", "init_params", "abstract_params", "axes_tree", "param_count",
    "tree_map", "leaves", "unflatten_like", "rmsnorm", "softcap",
    "grad_cast_bf16", "rope", "dense",
    "masked_cache_update", "blockwise_attention", "heads_einsum",
    "attn_spec", "gqa_full",
    "gqa_decode", "mlp_spec", "mlp_apply", "embed_spec", "embed_apply",
    "logits_apply",
]

DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    axes: str                      # comma-joined logical axes, '.' = repl.
    dtype: Any = DTYPE
    init: str = "normal"           # normal | zeros | ones | embed
    fan_in: Optional[int] = None   # override for stacked shapes


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (the first tree's keys; the
    other trees must hold the same keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree, prefix=()):
    """(path, leaf) pairs in sorted key order (the reference's pytree
    order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def leaves(tree) -> list:
    """The leaves of nested dicts in sorted key order (``jax.tree.leaves``'
    order)."""
    return [leaf for _, leaf in _leaves(tree)]


def unflatten_like(tree, flat_leaves):
    """A tree shaped as ``tree`` holding ``flat_leaves``, given in
    ``leaves(tree)``'s order."""
    paths = [path for path, _ in _leaves(tree)]
    return _unflatten(tree, dict(zip(paths, flat_leaves, strict=True)))


def init_params(spec_tree, *, generator: torch.Generator, device=None):
    """Real tensors for a spec tree: normal with std 1/sqrt(fan_in)
    (fan_in defaults to the second-to-last dim), std 1 for ``embed``,
    zeros and ones. Leaves draw from ``generator`` in sorted key order;
    ``device`` defaults to the generator's."""
    device = torch.device(device) if device is not None else generator.device

    def one(s: PSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=device)
        if s.init != "embed":
            fan_in = s.fan_in or (s.shape[-2] if len(s.shape) >= 2
                                  else s.shape[-1])
            x.mul_(1.0 / math.sqrt(max(1, fan_in)))
        return x.to(s.dtype)

    flat = {path: one(s) for path, s in _leaves(spec_tree)}
    return _unflatten(spec_tree, flat)


def _unflatten(tree, flat, prefix=()):
    if isinstance(tree, dict):
        return {k: _unflatten(v, flat, prefix + (k,)) for k, v in tree.items()}
    return flat[prefix]


def abstract_params(spec_tree):
    """``meta`` tensors of the spec's shapes and dtypes: no allocation."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), spec_tree)


def axes_tree(spec_tree):
    return tree_map(lambda s: s.axes, spec_tree)


def param_count(spec_tree) -> int:
    return sum(math.prod(s.shape) for _, s in _leaves(spec_tree))


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, *, eps: float = 1e-6, plus_one: bool = False):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    s = scale.float()
    s = s + 1.0 if plus_one else s
    return (y * s).to(x.dtype)


def softcap(x, cap: Optional[float]):
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


class _GradCastBf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def grad_cast_bf16(x):
    """Identity that casts the COTANGENT to bf16 (the reference's
    ``custom_vjp``): at block boundaries it keeps float32 cotangents born
    in float32-accumulated ops from running through the whole backward.
    Serving uses the forward only."""
    if not torch.is_grad_enabled():
        return x
    return _GradCastBf16.apply(x)


def rope(x, positions, *, base: float = 10000.0):
    """x: (..., S, H, hd) with positions (..., S). Split halves (not
    interleaved pairs); angles in float32, the result cast back."""
    hd = x.shape[-1]
    half = hd // 2
    freq = base ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = positions[..., :, None].float() * freq       # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def dense(x, w):
    """x: (..., d_in), w: (d_in, ...out). Contract the last dim of x, in
    the model dtype."""
    return torch.tensordot(x, w, dims=([x.ndim - 1], [0]))


def masked_cache_update(cache, new, pos, *, axis: int = 1):
    """Write one token's entry ``new`` (size 1 along ``axis``) into
    ``cache`` at ``pos``, in place, and return ``cache``. ``pos`` is an
    int or a one-element int64 tensor on the cache's device (no host
    read)."""
    if new.shape[axis] != 1:
        raise ValueError(f"new entry has {new.shape[axis]} positions, not 1")
    pos = torch.as_tensor(pos, dtype=torch.long,
                          device=cache.device).reshape(1)
    if SH.is_dtensor(cache):
        return SH.write_at(cache, new, pos, axis)
    cache.index_copy_(axis, pos, new.to(cache.dtype))
    return cache


# ---------------------------------------------------------------------------
# blockwise (flash-style) attention
# ---------------------------------------------------------------------------

def _pad(x, n, axis):
    if x.shape[axis] == n:
        return x
    shape = list(x.shape)
    shape[axis] = n - x.shape[axis]
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        q_positions=None,
                        logit_cap: Optional[float] = None,
                        q_chunk: int = 512, kv_chunk: int = 1024,
                        scale: Optional[float] = None,
                        skip_masked_blocks: bool = False):
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd). GQA via head grouping.
    Never materializes (Sq, Skv); memory is O(q_chunk * kv_chunk).

    ``window``: a kv position t is visible from query position s iff
    s - window < t <= s. ``q_positions``: absolute positions of the
    queries (default arange); kv positions are arange(Skv).

    ``skip_masked_blocks``: visit only the kv blocks that can be visible:
    a band of ceil((q_chunk+window)/kv_chunk)+1 blocks for window layers,
    the causal prefix for global ones. The numerics are the full loop's.

    On a mesh (DTensor q, k, v) each rank attends its own (batch, head)
    block: batch over the batch axes, heads over "model" where the kv
    heads divide, a region of plain tensors (``_per_head``).
    """
    if SH.is_dtensor(q):
        return _per_head(blockwise_attention, q, k, v, causal=causal,
                         window=window, q_positions=q_positions,
                         logit_cap=logit_cap, q_chunk=q_chunk,
                         kv_chunk=kv_chunk, scale=scale,
                         skip_masked_blocks=skip_masked_blocks)
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if q_positions is None:
        q_positions = torch.arange(Sq, dtype=torch.int32, device=dev)

    nq = -(-Sq // q_chunk)
    nk = -(-Skv // kv_chunk)
    Sq_pad, Skv_pad = nq * q_chunk, nk * kv_chunk

    qp = _pad(q, Sq_pad, 1).reshape(B, nq, q_chunk, Hkv, G, hd).float()
    kp = _pad(k, Skv_pad, 1).reshape(B, nk, kv_chunk, Hkv, hd)
    vp = _pad(v, Skv_pad, 1).reshape(B, nk, kv_chunk, Hkv, hd)
    qpos = _pad(q_positions, Sq_pad, 0).reshape(nq, q_chunk)
    kpos = torch.arange(Skv_pad, dtype=torch.int32,
                        device=dev).reshape(nk, kv_chunk)
    kvalid = (torch.arange(Skv_pad, device=dev) < Skv).reshape(nk, kv_chunk)

    def kv_step(carry, qc, pos_q, ki):
        m, l, acc = carry
        kc, vc = kp[:, ki], vp[:, ki]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc.float()) * scale
        s = softcap(s, logit_cap)
        mask = kvalid[ki][None, :]
        if causal:
            mask = mask & (kpos[ki][None, :] <= pos_q[:, None])
        if window is not None:
            mask = mask & (kpos[ki][None, :] > pos_q[:, None] - window)
        s = torch.where(mask[None, None, None], s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l_new = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vc.dtype).float(),
                          vc.float())
        return m_new, l_new, acc * corr[..., None] + pv

    outs = []
    for qi in range(nq):
        qc, pos_q = qp[:, qi], qpos[qi]
        carry = (torch.full((B, Hkv, G, q_chunk), -math.inf, device=dev),
                 torch.zeros((B, Hkv, G, q_chunk), device=dev),
                 torch.zeros((B, Hkv, G, q_chunk, hd), device=dev))
        if skip_masked_blocks and window is not None:
            # only kv blocks meeting [q_start - window, q_end] can be
            # visible: a fixed-size band
            nband = min(nk, (q_chunk + window) // kv_chunk + 2)
            first = max((qi * q_chunk - window) // kv_chunk, 0)
            first = min(first, nk - nband)
            blocks = range(first, first + nband)
        elif skip_masked_blocks and causal:
            # causal prefix: kv blocks after this q block are fully masked
            nneed = min(nk, (Sq_pad + kv_chunk - 1) // kv_chunk)
            blocks = [j for j in range(nneed)
                      if j * kv_chunk <= qi * q_chunk + q_chunk - 1]
        else:
            blocks = range(nk)
        for ki in blocks:
            carry = kv_step(carry, qc, pos_q, ki)
        m, l, acc = carry
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.stack(outs, dim=3)                  # (B, Hkv, G, nq, qc, hd)
    out = out.reshape(B, Hkv, G, Sq_pad, hd)[:, :, :, :Sq]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def _per_head(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` on each rank's (batch, head) block of DTensor
    q, k, v (B, S, H or Hkv, hd): attention mixes neither, so the blocks'
    outputs are the output's, and each block's gradients its own. The
    heads are split over "model" only where the kv heads divide (q's
    head h = kv * G + g then splits with its kv head)."""
    mesh = q.device_mesh
    spec = SH.logical_to_spec(mesh, ("batch", None, "heads", None),
                              tuple(k.shape))
    pl = SH.placements(mesh, spec)
    out = fn(*(SH.local_region(t, spec, pl) for t in (q, k, v)), **kw)
    return SH.from_region(out, mesh, pl, q.shape)


# ---------------------------------------------------------------------------
# GQA attention layer (spec + full/decode applies)
# ---------------------------------------------------------------------------

def attn_spec(d_model: int, n_heads: int, n_kv: int, head_dim: int, *,
              qkv_bias: bool = False, qk_norm: bool = False,
              stack: Optional[int] = None) -> Dict[str, PSpec]:
    st = (stack,) if stack else ()
    pre = "stack," if stack else ""
    s = {
        "wq": PSpec(st + (d_model, n_heads, head_dim),
                    pre + "fsdp,heads,.", fan_in=d_model),
        "wk": PSpec(st + (d_model, n_kv, head_dim),
                    pre + "fsdp,heads,.", fan_in=d_model),
        "wv": PSpec(st + (d_model, n_kv, head_dim),
                    pre + "fsdp,heads,.", fan_in=d_model),
        "wo": PSpec(st + (n_heads, head_dim, d_model),
                    pre + "heads,.,fsdp", fan_in=n_heads * head_dim),
    }
    if qkv_bias:
        s["bq"] = PSpec(st + (n_heads, head_dim), pre + "heads,.",
                        init="zeros")
        s["bk"] = PSpec(st + (n_kv, head_dim), pre + "heads,.", init="zeros")
        s["bv"] = PSpec(st + (n_kv, head_dim), pre + "heads,.", init="zeros")
    if qk_norm:
        s["q_norm"] = PSpec(st + (head_dim,), pre + ".", init="ones")
        s["k_norm"] = PSpec(st + (head_dim,), pre + ".", init="ones")
    return s


_HEADS = {"b": "batch", "h": "heads"}


def heads_einsum(eq: str, *operands):
    """``torch.einsum(eq, *operands)`` for the head projections and the
    attention products around them (``b`` the batch, ``h`` the heads). On
    a mesh a region of plain tensors (``sharding.einsum``): the batch
    over the batch axes and the heads over "model" where they divide,
    every other axis whole on each rank, so heads the "model" axis does
    not divide are computed whole on each of its ranks."""
    if any(SH.is_dtensor(o) for o in operands):
        return SH.einsum(eq, *operands, split=_HEADS)
    return torch.einsum(eq, *operands)


def _project_qkv(p, x, positions, *, rope_base, qk_norm):
    q = heads_einsum("bsd,dhk->bshk", x, p["wq"])
    k = heads_einsum("bsd,dhk->bshk", x, p["wk"])
    v = heads_einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"][None, None]
        k = k + p["bk"][None, None]
        v = v + p["bv"][None, None]
    if qk_norm:            # before rope
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if rope_base:
        q = rope(q, positions, base=rope_base)
        k = rope(k, positions, base=rope_base)
    return q, k, v


def gqa_full(p, x, *, rope_base: float = 10000.0, causal: bool = True,
             window: Optional[int] = None, qk_norm: bool = False,
             logit_cap: Optional[float] = None,
             q_chunk: int = 512, kv_chunk: int = 1024,
             skip_masked_blocks: bool = False):
    """Prefill path. x: (B, S, D). Returns (out, (k, v)), k roped."""
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, positions, rope_base=rope_base,
                           qk_norm=qk_norm)
    out = blockwise_attention(q, k, v, causal=causal, window=window,
                              logit_cap=logit_cap, q_chunk=q_chunk,
                              kv_chunk=kv_chunk,
                              skip_masked_blocks=skip_masked_blocks)
    out = heads_einsum("bshk,hkd->bsd", out, p["wo"])
    return out, (k, v)


def gqa_decode(p, x, cache_k, cache_v, pos, *, rope_base: float = 10000.0,
               window: Optional[int] = None, qk_norm: bool = False,
               logit_cap: Optional[float] = None):
    """Single-token decode. x: (B, 1, D); cache_k/v: (B, Smax, Hkv, hd),
    written in place at ``pos`` (an int or a one-element int64 tensor).
    Scores are float32 over the WHOLE Smax, masked to t <= pos (and
    t > pos - window), as the reference reads them. Returns (out,
    cache_k, cache_v)."""
    pos = torch.as_tensor(pos, dtype=torch.long, device=x.device).reshape(1)
    q, k_new, v_new = _project_qkv(p, x, pos, rope_base=rope_base,
                                   qk_norm=qk_norm)
    masked_cache_update(cache_k, k_new, pos, axis=1)
    masked_cache_update(cache_v, v_new, pos, axis=1)
    attend = _attend_split if SH.is_dtensor(cache_k) else _attend
    out = attend(q, cache_k, cache_v, pos, window=window,
                 logit_cap=logit_cap).to(x.dtype)
    out = heads_einsum("bshk,hkd->bsd", out, p["wo"])
    return out, cache_k, cache_v


def _decode_scores(q, cache_k, pos, first, *, window, logit_cap):
    """float32 scores (B, Hkv, G, T) of one query token q (B, 1, H, hd)
    against cache positions ``first`` .. ``first + T - 1`` of ``cache_k``
    (B, T, Hkv, hd), masked to t <= pos (and t > pos - window)."""
    B, T, Hkv = cache_k.shape[:3]
    H = q.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, -1)
    s = torch.einsum("bhgk,bthk->bhgt", qg.float(), cache_k.float())
    s = s / math.sqrt(q.shape[-1])
    s = softcap(s, logit_cap)
    t = torch.arange(T, device=s.device) + first
    mask = t <= pos
    if window is not None:
        mask = mask & (t > pos - window)
    return torch.where(mask, s, -math.inf)


def _attend(q, cache_k, cache_v, pos, *, window, logit_cap):
    """Attention of q (B, 1, H, hd) over the whole cache: float32
    (B, 1, H, hd)."""
    s = _decode_scores(q, cache_k, pos, 0, window=window,
                       logit_cap=logit_cap)
    a = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bthk->bhgk", a, cache_v.float())
    return out.reshape(q.shape[0], 1, q.shape[2], -1)


def _attend_split(q, cache_k, cache_v, pos, *, window, logit_cap):
    """``_attend`` over a DTensor cache whose sequence is split over
    "model" (``lm.cache_axes``; flash-decoding): each rank attends its
    block of positions as ``_attend`` does (softmax, then the values),
    and the blocks' outputs are summed over "model", each weighted by
    its share of the whole softmax's mass, l_i exp(m_i - M) / sum_j
    l_j exp(m_j - M) with m_i the block's max score, l_i its sum of
    exp(s - m_i) and M the max of all (all-reduces over "model"). One
    block weighs exactly 1. Serving only (no autograd)."""
    mesh = cache_k.device_mesh
    cspec = SH.logical_to_spec(mesh, ("batch", "kv_seq_model", None, None),
                               tuple(cache_k.shape))
    qspec = (cspec[0], None, None, None)
    cpl = SH.placements(mesh, cspec)
    ck, cv = (t.redistribute(mesh, cpl) for t in (cache_k, cache_v))
    ql = q.redistribute(mesh, SH.placements(mesh, qspec)).to_local()
    s = _decode_scores(ql, ck.to_local(), pos.to(ql.device),
                       SH.local_offset(ck, 1), window=window,
                       logit_cap=logit_cap)
    m = s.amax(dim=-1)
    seen = torch.isfinite(m)           # a block may see no position
    m0 = torch.where(seen, m, 0.0)
    a = torch.where(seen[..., None], torch.softmax(s, dim=-1), 0.0)
    o = torch.einsum("bhgt,bthk->bhgk", a, cv.to_local().float())
    if cspec[1] is not None:
        group = mesh.get_group("model")
        top = m.clone()                # some block sees pos itself
        torch.distributed.all_reduce(top, torch.distributed.ReduceOp.MAX,
                                     group=group)
        w = torch.where(seen, torch.exp(s - m0[..., None]).sum(dim=-1)
                        * torch.exp(m0 - top), 0.0)
        total = w.clone()
        torch.distributed.all_reduce(total, group=group)
        o = o * (w / total)[..., None]
        torch.distributed.all_reduce(o, group=group)
    out = o.reshape(ql.shape[0], 1, ql.shape[2], -1)
    return SH.from_region(out, mesh, SH.placements(mesh, qspec),
                          q.shape[:3] + (cache_v.shape[-1],))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_spec(d_model: int, d_ff: int, *, gated: bool = True,
             stack: Optional[int] = None) -> Dict[str, PSpec]:
    st = (stack,) if stack else ()
    pre = "stack," if stack else ""
    s = {
        "w_up": PSpec(st + (d_model, d_ff), pre + "fsdp,model",
                      fan_in=d_model),
        "w_down": PSpec(st + (d_ff, d_model), pre + "model,fsdp",
                        fan_in=d_ff),
    }
    if gated:
        s["w_gate"] = PSpec(st + (d_model, d_ff), pre + "fsdp,model",
                            fan_in=d_model)
    return s


def mlp_apply(p, x, *, act: str = "silu"):
    """silu and gelu (tanh form) in float32, cast back before the product
    with ``up``; relu2 and relu in the model dtype."""
    up = dense(x, p["w_up"])
    if "w_gate" in p:
        g = dense(x, p["w_gate"]).float()
        if act == "silu":
            h = F.silu(g).to(x.dtype) * up
        else:
            h = F.gelu(g, approximate="tanh").to(x.dtype) * up
    else:
        if act == "relu2":   # nemotron/minitron squared relu
            r = torch.relu(up)
            h = r * r
        elif act == "relu":
            h = torch.relu(up)
        else:
            h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    return dense(h, p["w_down"])


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------

def embed_spec(vocab: int, d_model: int) -> PSpec:
    return PSpec((vocab, d_model), "vocab,.", init="embed")


def embed_apply(table, tokens, *, scale: bool = False):
    """Rows of ``table``; with ``scale`` times sqrt(d) rounded to the
    table's dtype first (bf16 73.32 -> 73.5 for d = 5376). A DTensor
    table is looked up block by block (``_embed_split``)."""
    x = _embed_split(table, tokens) if SH.is_dtensor(table) else \
        table[tokens]
    if scale:
        x = x * torch.tensor(math.sqrt(table.shape[1]), dtype=x.dtype).item()
    return x


def _embed_split(table, tokens):
    """The rows of a DTensor ``table`` (V, d) for ``tokens`` (B, S), as
    the reference's sharded gather computes them: each rank looks its
    batch block's tokens up in its own block of the vocabulary (zero
    where another block holds the row), and a sum over the vocabulary's
    axes completes the rows. Each rank's table gradient is its tokens'
    part, summed over the batch axes."""
    mesh = table.device_mesh
    vocab = tuple(n for n, p in zip(mesh.mesh_dim_names, table.placements)
                  if p.is_shard(0))
    tok = SH.constrain(tokens, mesh, ("batch", None))
    batch = SH.logical_to_spec(mesh, ("batch", None), tuple(tok.shape))[0]
    tspec = (vocab[0] if len(vocab) == 1 else (vocab or None), None)
    blocks = table.redistribute(mesh, SH.placements(mesh, tspec))
    off = SH.local_offset(blocks, 0)
    local = blocks.to_local(grad_placements=SH.placements(
        mesh, tspec, SH.axes_of(batch)))
    idx = tok.to_local() - off
    mine = (idx >= 0) & (idx < local.shape[0])
    rows = torch.where(mine[..., None],
                       local[idx.clamp(0, local.shape[0] - 1)], 0)
    out = SH.from_region(rows, mesh, SH.placements(
        mesh, (batch, None, None), vocab), tuple(tok.shape) + (
            table.shape[1],))
    return SH.settle(out)


def logits_apply(table_or_w, x, *, transpose: bool = True,
                 cap: Optional[float] = None):
    """The product in the model dtype, then float32, then the softcap."""
    if transpose:  # tied embedding (vocab, d)
        out = torch.einsum("bsd,vd->bsv", x, table_or_w)
    else:
        out = torch.einsum("bsd,dv->bsv", x, table_or_w)
    return softcap(out.float(), cap)
