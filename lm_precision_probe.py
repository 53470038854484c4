#!/usr/bin/env python3
"""Where xlstm-350m's logits leave the reference's tolerance on the card,
and why. It logs readings and holds nothing to a limit; chip_smoke.py's
LM_SMALL_BF16_OUTSIDE and LM_F32_OUTSIDE were set from them.

    python3 lm_precision_probe.py    # from the root of a checkout, one card

1. The reduced config in bf16, the card against the CPU from the same
   weights and tokens (chip_smoke.py's lm_serve phase (a)): prefill logits
   and one decode step, under three settings of the card's products:
   PyTorch's default; cuBLAS's reduced-precision bf16 reduction turned off
   (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction);
   and every product of the bf16 weights (``layers.dense`` and the
   logits) computed in float32 and rounded once to bf16, on the card and
   the CPU alike. Then under the default over its first 1, 2, 4 and 8 of
   16 layers, to show how the gap grows with depth.
2. The full-width config (24 layers, d_model 1024) in float32, batch 8, a
   512-token prompt: decode at T against lm_forward at T (chip_smoke.py's
   float32 consistency check), with the reference's bf16 conv buffer and
   with a float32 one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys

import chip_smoke as CS

ARCH = "xlstm-350m"
DEPTHS = (1, 2, 4, 8)       # (1) again over the reduced config's first layers


@contextlib.contextmanager
def patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def dense_f32():
    """Every product of the model dtype's weights (``layers.dense`` and the
    logits) in float32, rounded once to the input's dtype."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SSM

    def dense(x, w):
        return torch.tensordot(x.float(), w.float(),
                               dims=([x.ndim - 1], [0])).to(x.dtype)

    def logits(table_or_w, x, *, transpose=True, cap=None):
        out = torch.einsum("bsd,vd->bsv" if transpose else "bsd,dv->bsv",
                           x.float(), table_or_w.float())
        return L.softcap(out.to(x.dtype).float(), cap)
    with patched(L, "dense", dense), patched(SSM, "dense", dense), \
            patched(L, "logits_apply", logits):
        yield


@contextlib.contextmanager
def conv_f32():
    """The conv buffer of the recurrent mixers in the model's dtype, not
    bf16: the prefill's tail and the serving cache both."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import lm as LM
    from repro_torch.models import ssm as SSM
    shapes = LM._block_cache_shapes

    def cache_shapes(kind, cfg, batch, max_len):
        out = shapes(kind, cfg, batch, max_len)
        if "conv" in out:
            out["conv"] = (out["conv"][0], torch.float32)
        return out

    def tail(x):
        S = x.shape[1]
        return F.pad(x, (0, 0, SSM.CONV_W - 1, 0))[:, S:S + SSM.CONV_W - 1]
    with patched(LM, "_block_cache_shapes", cache_shapes), \
            patched(SSM, "_conv_tail", tail):
        yield


def first_layers(cfg, params, n: int):
    """The model of the first ``n`` layers of a config with no tail: whole
    repeats of its pattern, or the first ``n`` blocks of one repeat."""
    from repro_torch.models import layers as L
    P = len(cfg.block_pattern)
    if n % P == 0:
        return CS.cut_depth(L, cfg, params, n // P)
    stage = {str(i): L.tree_map(lambda t: t[:1], params["stage"][str(i)])
             for i in range(n)}
    return (dataclasses.replace(cfg, block_pattern=cfg.block_pattern[:n],
                                repeats=1), dict(params, stage=stage))


def reduced(torch, seed: int, setting: str, layers=None) -> None:
    """(1) under one ``setting`` of the products, over the first
    ``layers`` layers (all by default)."""
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.serve import engine as S
    B, T, new = CS.LM_SMALL
    cfg = configs.get(ARCH, reduced=True)
    cpu = L.init_params(LM.lm_spec(cfg),
                        generator=torch.Generator().manual_seed(seed))
    if layers is not None:
        cfg, cpu = first_layers(cfg, cpu, layers)
    tokens, _ = CS.lm_prompt(cfg, B, T + 1, seed)
    runs = {}
    for dev in ("cpu", "cuda"):
        params = L.tree_map(lambda t: t.to(dev), cpu)
        prefill, decode, init_cache = S.make_serve_fns(
            cfg, batch=B, max_len=T + new + 1, device=dev)
        logits, pcache = prefill(params, tokens[:, :T])
        cache = S.place_prefill_cache(cfg, pcache, init_cache(), T)
        step, _ = decode(params, cache, tokens[:, T:], T)
        runs[dev] = (logits, step)
    reduction = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    for i, tag in enumerate(("probe_reduced_prefill", "probe_reduced_decode")):
        CS.lm_diff(tag, runs["cuda"][i], runs["cpu"][i], arch=ARCH,
                   layers=cfg.n_layers, setting=setting,
                   bf16_reduced_precision_reduction=reduction)


def full_f32(torch, seed: int) -> None:
    """(2): bf16 params from ``seed`` as chip_smoke.py makes them, the
    first greedy token of their bf16 prefill, then the float32 check with
    each conv buffer."""
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.serve import engine as S
    cfg = configs.get(ARCH)
    B, T = CS.LM_BATCH, CS.LM_PROMPT
    params = L.init_params(LM.lm_spec(cfg), generator=torch.Generator(
        device="cuda").manual_seed(seed))
    tokens, _ = CS.lm_prompt(cfg, B, T, seed)
    prefill, _, _ = S.make_serve_fns(cfg, batch=B, max_len=T + 1,
                                     device="cuda")
    logits, _ = prefill(params, tokens)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    del logits

    def log_only(tag, got, want, outside=0.0, **fields):
        return CS.lm_diff(tag, got, want, **fields)
    with patched(CS, "lm_agree", log_only):
        for buffer, ctx in (("bf16", contextlib.nullcontext), ("f32", conv_f32)):
            CS.log("lm_probe", arch=ARCH, conv_buffer=buffer)
            with ctx():
                CS.consistency_f32(torch, cfg, params, tokens, tok, cfg.repeats)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("lm_precision_probe: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(CS.ROOT / "src"))
    CS.log("device", kind=repr(torch.cuda.get_device_name(0)),
           nvidia_smi=repr(CS.nvidia_smi_line()), torch=torch.__version__,
           cuda=torch.version.cuda)
    seed = 0
    flag = torch.backends.cuda.matmul
    reduced(torch, seed, "default")
    with patched(flag, "allow_bf16_reduced_precision_reduction", False):
        reduced(torch, seed, "no_reduced_precision_reduction")
    with dense_f32():
        reduced(torch, seed, "dense_in_f32_rounded_once")
    for layers in DEPTHS:
        reduced(torch, seed, "default", layers)
    full_f32(torch, seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
