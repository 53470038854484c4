"""Three-term roofline of one step on one card (the port of
``repro.launch.roofline``).

Each term is in seconds a step, per device:

  compute    = flops_per_device / peak FLOP/s
  memory     = bytes_per_device / HBM bytes/s
  collective = wire_bytes_per_device / collective bytes/s

The formulas are the reference's (``model_flops``, ``analytic_hbm_bytes``
and ``roofline`` as they are); the hardware is an argument, and its
default is the card's (:data:`H100`). The reference reads its collectives
from XLA's compiled HLO; the port records each collective the step
issues (``launch.dryrun``) and turns its bytes into wire bytes with the
reference's ring-cost factors (:func:`ring_wire_bytes`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..core import perfmodel

__all__ = ["Hardware", "H100", "H100_STREAM", "ring_wire_bytes",
           "model_flops", "analytic_hbm_bytes", "roofline"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    """The rates a roofline divides by, and the memory of one device."""
    name: str
    peak_flops: float        # FLOP/s, bf16 dense
    hbm_bytes_per_s: float   # device memory, bytes/s
    link_bytes_per_s: float  # the collective rate of one device, bytes/s
    hbm_bytes: float         # device memory, bytes


# NVIDIA H100 SXM 80GB. peak_flops: 989 TFLOP/s bf16 dense (data sheet);
# hbm_bytes_per_s: 3.35 TB/s (data sheet); hbm_bytes: 80 GB (data sheet).
# link_bytes_per_s: one 400 Gb/s NIC a card (50e9 B/s, data sheet, not
# measured): both axes of the (16, 16) mesh span more than one 8-card
# node, so a collective leaves the node. NVLink 4 within a node is
# faster (900 GB/s a card, data sheet); no multi-card wire was measured.
H100 = Hardware("NVIDIA H100 80GB HBM3 (data sheet)", peak_flops=989e12,
                hbm_bytes_per_s=3.35e12, link_bytes_per_s=50e9,
                hbm_bytes=80e9)
# The same card at the stream rate core/perfmodel.H100 holds (measured: a
# 4 GiB read, chip_smoke.py's platform phase, NVIDIA H100 80GB HBM3 at
# 700 W).
H100_STREAM = dataclasses.replace(
    H100, name="NVIDIA H100 80GB HBM3 (measured stream rate)",
    hbm_bytes_per_s=perfmodel.H100.bw_mem)


def ring_wire_bytes(op: str, nbytes: float, group_size: int) -> float:
    """The bytes one device puts on the wire for a collective over
    ``group_size`` devices, by the reference's ring-cost factors
    (``parse_collectives``), ``nbytes`` being the op's result:

      all-gather          result * (P-1)/P   (result = gathered)
      all-reduce          2 * bytes * (P-1)/P
      reduce-scatter      result * (P-1)
      all-to-all          bytes * (P-1)/P
      collective-permute  bytes

    A group of one device moves nothing."""
    p = group_size
    if p <= 1:
        return 0.0
    if op == "all-gather":
        return nbytes * (p - 1) / p
    if op == "all-reduce":
        return 2 * nbytes * (p - 1) / p
    if op == "reduce-scatter":
        return nbytes * (p - 1)
    if op == "all-to-all":
        return nbytes * (p - 1) / p
    if op == "collective-permute":
        return nbytes
    raise ValueError(f"unknown collective {op!r}")


def model_flops(n_params_active: int, tokens: int, kind: str) -> float:
    """6·N·D for training, 2·N·D for inference forward (MoE: N = active)."""
    factor = 6.0 if kind == "train" else 2.0
    return factor * n_params_active * tokens


def analytic_hbm_bytes(*, n_params: int, n_params_active: int, tokens: int,
                       d_model: int, n_layers: int, vocab: int,
                       n_dev: int, dp: int, tp: int, kind: str,
                       microbatch: int = 1,
                       cache_bytes_per_dev: float = 0.0) -> float:
    """Fused-execution HBM-traffic estimate per device (a lower bound).

    train: every microbatch streams the gathered weights 3x (fwd, remat
    fwd, bwd), the optimizer reads/writes grads f32 + m/v f32 + params,
    remat boundary activations are written+read once, logits 3 passes.
    prefill: one weight stream + KV-cache write.
    decode: one ACTIVE-weight stream (MoE touches topk/n experts at
    batch*1 tokens) + full cache read + cache write."""
    p_dev = 2.0 * n_params / max(tp, 1)  # TP-resident share per device
    tok_dev = tokens / max(dp, 1)
    act = tok_dev * d_model * 2.0 * n_layers
    if kind == "train":
        w = 3.0 * microbatch * p_dev             # gathered weight streams
        opt = 18.0 * n_params / n_dev            # g(4rw=8)+m,v(8)+p(2)
        logits = 3.0 * tokens * vocab * 4.0 / n_dev
        return w + opt + 2.0 * act + logits
    if kind == "prefill":
        return p_dev + 2.0 * act + cache_bytes_per_dev
    # decode
    return 2.0 * n_params_active / max(tp, 1) + 3.0 * cache_bytes_per_dev


def roofline(cost: dict, colls: Dict[str, float], *,
             n_devices: int, tokens: int, n_params_active: int,
             kind: str, analytic_bytes: Optional[float] = None,
             hw: Hardware = H100) -> Dict[str, float]:
    """Three-term roofline at ``hw``'s rates. ``cost``: "flops" and
    "bytes accessed" per device; ``colls``: "total_wire_bytes" per
    device. The memory term has two sources: ``cost``'s bytes (an upper
    bound: every operator's reads and writes, unfused) and the analytic
    fused-execution estimate (a lower bound; see analytic_hbm_bytes).
    Headline numbers use the analytic term when available; both are
    reported."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    wire_dev = colls.get("total_wire_bytes", 0.0)
    t_compute = flops_dev / hw.peak_flops
    t_memory_hlo = bytes_dev / hw.hbm_bytes_per_s
    t_memory = (analytic_bytes / hw.hbm_bytes_per_s
                if analytic_bytes is not None else t_memory_hlo)
    t_coll = wire_dev / hw.link_bytes_per_s
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    mf = model_flops(n_params_active, tokens, kind)
    hlo_flops_global = flops_dev * n_devices
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_memory_hlo_upper_s": t_memory_hlo,
        "t_collective_s": t_coll,
        "bound_by": dominant,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "analytic_bytes_per_device": analytic_bytes,
        "wire_bytes_per_device": wire_dev,
        "model_flops_global": mf,
        "hlo_flops_global": hlo_flops_global,
        "useful_flop_ratio": (mf / hlo_flops_global
                              if hlo_flops_global else 0.0),
        # step time if perfectly overlapped = max term; roofline fraction =
        # useful-compute time over that bound.
        "roofline_step_s": max(t_compute, t_memory, t_coll),
        "mfu_bound": (mf / n_devices / hw.peak_flops)
                     / max(t_compute, t_memory, t_coll, 1e-30),
    }
