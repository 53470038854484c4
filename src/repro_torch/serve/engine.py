"""Serving engine: batched prefill + decode with static cache buffers (the
port of ``repro.serve.engine``).

``make_serve_fns(cfg, batch=, max_len=)`` builds the pair
  prefill(params, tokens, prefix=None) -> (last-position logits, cache)
  decode(params, cache, tokens, pos)   -> (logits, cache)
and the cache's allocator. There is no jit: PyTorch runs eagerly, each
call under ``torch.inference_mode()``. ``decode`` updates the cache in
place and returns the same buffers (the reference donates its cache to
the jitted step): new k/v and MLA latents at ``pos``, recurrent states
replaced. KV and latent buffers are allocated at ``max_len`` on the
serving device; recurrent states are O(1) in the sequence.

Every entry point runs on the card unless the caller passes
``device="cpu"``; it raises when there is no card, and when the params
lie on another device than the one it serves on.

With ``mesh`` (a ``DeviceMesh``, the reference's ``mesh`` argument) the
params are DTensors placed by ``sharding.param_sharding_rules``, the
prompt is sharded over the batch axes, and the cache is placed by
``lm.cache_axes``: batch over data, the KV sequence over "model". Each
call then runs under ``torch.no_grad()`` (DTensor's views refuse
inference tensors), and the greedy tokens are read from the gathered
last-position logits.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import sharding as SH
from ..core.engine import resolve_device
from ..models import lm as LM

__all__ = ["make_serve_fns", "place_prefill_cache", "greedy_token",
           "greedy_generate"]


def _tokens(tokens, device) -> torch.Tensor:
    if SH.is_dtensor(tokens):
        return tokens
    return torch.as_tensor(tokens, dtype=torch.long, device=device)


def _no_grad(mesh):
    return torch.inference_mode() if mesh is None else torch.no_grad()


def _serving_device(device, mesh):
    """The device served on: the mesh's, or the card unless "cpu" is
    asked for."""
    if mesh is not None:
        if device is not None and torch.device(device).type != \
                mesh.device_type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device_type}")
        device = mesh.device_type
    return resolve_device(device)


def greedy_token(logits) -> torch.Tensor:
    """The last position's argmax, (B, 1), a plain tensor (the same on
    every rank)."""
    last = logits[:, -1, :]
    if SH.is_dtensor(last):
        last = last.full_tensor()
    return last.argmax(dim=-1, keepdim=True)


def place_prefill_cache(cfg: LM.ArchCfg, prefill_cache, buffers, seq_len):
    """Copy prefill-produced caches into the ``max_len`` buffers, in
    place; returns ``buffers``. An entry shorter than its buffer along
    the sequence (attention k/v, MLA latents) is pasted at offset 0; a
    recurrent state has its buffer's shape and replaces it outright (cast
    to the buffer's dtype), as the reference's ``merge`` does.
    ``seq_len`` is the reference's argument, unused there too: the shapes
    say where to paste."""
    def merge(buf, new):
        if SH.is_dtensor(buf):
            return SH.paste(buf, new)   # each rank into its own block
        if buf.shape != new.shape and buf.ndim == new.ndim:
            buf[tuple(slice(0, n) for n in new.shape)].copy_(new)
        else:
            buf.copy_(new)
        return buf
    on_mesh = SH.is_dtensor(LM.L.leaves(buffers)[0])
    with torch.no_grad() if on_mesh else torch.inference_mode():
        return LM.L.tree_map(merge, buffers, prefill_cache)


def make_serve_fns(cfg: LM.ArchCfg, mesh=None, *, batch: int,
                   max_len: int, device=None, prefix_embeds: bool = False):
    """Returns (prefill_fn, decode_fn, init_cache_fn) on ``device`` (the
    card unless "cpu" is asked for), or on ``mesh``'s devices.
    ``prefix_embeds`` is the reference's flag and changes nothing: a
    prefix is passed to ``prefill_fn``."""
    device = _serving_device(device, mesh)

    def init_cache_fn():
        cache = LM.init_cache(cfg, batch, max_len, device=device)
        if mesh is None:
            return cache
        return LM.place_cache(cache, cfg, mesh, batch=batch,
                              max_len=max_len)

    def prefill_fn(params, tokens, prefix=None):
        LM.check_device("params lie", params["embed"].device, device)
        with _no_grad(mesh):
            if prefix is not None and not SH.is_dtensor(prefix):
                prefix = torch.as_tensor(prefix, device=device)
            return LM.lm_forward(params, _tokens(tokens, device), cfg,
                                 mesh=mesh, prefix_embeds=prefix,
                                 return_cache=True, last_only=True)

    def decode_fn(params, cache, tokens, pos):
        LM.check_device("params lie", params["embed"].device, device)
        with _no_grad(mesh):
            return LM.lm_decode_step(params, cache, _tokens(tokens, device),
                                     pos, cfg, mesh=mesh)

    return prefill_fn, decode_fn, init_cache_fn


def greedy_generate(cfg: LM.ArchCfg, params, prompt_tokens, *,
                    num_new: int, max_len: Optional[int] = None,
                    mesh=None, prefix=None, device=None) -> np.ndarray:
    """End-to-end batched greedy decoding (prefill -> ``num_new`` - 1
    decode steps); returns the (B, num_new) new tokens as numpy.

    With a VLM ``prefix`` (B, Sp, D) the prompt's cache holds Sp + S
    positions, so decoding starts at position Sp + S and the default
    ``max_len`` counts the prefix too (ROADMAP §3: the reference starts
    at S and sizes its buffers without the prefix)."""
    B, S = prompt_tokens.shape
    start = S + (0 if prefix is None else prefix.shape[1])
    max_len = max_len or (start + num_new + 1)
    prefill, decode, init_cache = make_serve_fns(
        cfg, mesh, batch=B, max_len=max_len, device=device)
    logits, pre_cache = prefill(params, prompt_tokens, prefix)
    cache = place_prefill_cache(cfg, pre_cache, init_cache(), start)
    tok = greedy_token(logits)
    out = [tok]
    # the position stays on the device: a host int would be copied up
    # each step, and that copy waits for the step before it
    pos = torch.full((1,), start, dtype=torch.long, device=tok.device)
    for _ in range(num_new - 1):
        logits, cache = decode(params, cache, tok, pos)
        tok = greedy_token(logits)
        out.append(tok)
        pos += 1
    return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
