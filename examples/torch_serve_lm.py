"""Serving demo on the PyTorch port: batched prefill + greedy decode with
KV caches for a dense arch and O(1)-state decode for a recurrent arch.

The twin of ``examples/serve_lm.py`` over ``repro_torch``: the same
reduced configs, prompts and printed lines. The weights are random from
seed 0, drawn on the CPU and moved to the device, so the card and the
CPU serve the same params (``params_for``).

  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.engine import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.serve.engine import greedy_generate

ARCHS = ("qwen3-4b", "xlstm-350m", "gemma3-27b")


def params_for(cfg, device="cpu"):
    """The demo's random params for ``cfg``, on ``device``."""
    params = L.init_params(LM.lm_spec(cfg),
                           generator=torch.Generator().manual_seed(0))
    return L.tree_map(lambda t: t.to(device), params)


def main(device=None):
    """Print one line per arch; return {arch: (prompts (4, 16), the
    generated tokens (4, 12))}."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    out = {}
    for arch in ARCHS:
        cfg = configs.get(arch, reduced=True)
        params = params_for(cfg, device)
        prompts = rng.integers(1, cfg.vocab, (4, 16)).astype(np.int32)
        gen = greedy_generate(cfg, params, prompts, num_new=12,
                              device=device)
        out[arch] = (prompts, gen)
        print(f"{arch:12s} generated {gen.shape[1]} tokens/request "
              f"batch={gen.shape[0]}; sample row: {gen[0][:8]}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
