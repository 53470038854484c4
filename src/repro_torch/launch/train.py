"""Training launcher (the port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --steps 100 --ckpt-dir /tmp/ckpt            # full config, the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --device cpu --steps 3            # reduced config, CPU

  torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \
      --arch qwen2-72b --production-mesh        # (16, 16), 256 cards

Trains on one card, or on the CPU with ``--device cpu``. The config is
the full one unless ``--reduced`` is given or the run is on the CPU (the
reference shrinks it whenever it sees a single device, a rule written for
its CPU box). The loop resumes from the latest complete checkpoint
automatically: relaunch after any failure, on any mesh (checkpoints
re-cut on restore).

``--production-mesh`` (and ``--multi-pod``, which implies it) joins the
process group ``torchrun`` describes (``--init-method``, env:// by
default; NCCL on the card, gloo on the CPU), builds the (16, 16) or
(2, 16, 16) mesh and shards the ``Trainer`` by the rules
(``sharding.py``). A world of another size exits with the mesh's error,
naming the ranks it needs. Rank 0 prints the log.
"""
from __future__ import annotations

import argparse
import os

import torch

from .. import configs
from ..data.pipeline import DataConfig
from ..train.loop import TrainConfig, Trainer
from ..train.optimizer import AdamWConfig


def _production_mesh(ap, args, on_cpu: bool):
    """Join the process group and build the production mesh; exit with
    the mesh's error in a world of another size."""
    import torch.distributed as dist

    from .mesh import make_production_mesh
    if not dist.is_initialized():
        backend = "gloo" if on_cpu else "nccl"
        if args.init_method == "env://" and "WORLD_SIZE" not in os.environ:
            # not under torchrun: a world of this one process
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0)
        else:
            dist.init_process_group(
                backend, init_method=args.init_method,
                world_size=int(os.environ["WORLD_SIZE"]),
                rank=int(os.environ["RANK"]))
    try:
        return make_production_mesh(multi_pod=args.multi_pod,
                                    device=args.device)
    except RuntimeError as e:
        dist.destroy_process_group()
        ap.exit(2, f"{ap.prog}: error: {e}\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale config (always on with --device cpu)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true",
                    help="shard over the (16,16) mesh (256 ranks)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2,16,16) mesh (512 ranks)")
    ap.add_argument("--init-method", default="env://",
                    help="process group rendezvous (torchrun: env://)")
    args = ap.parse_args(argv)

    on_cpu = args.device is not None and args.device.startswith("cpu")
    mesh = None
    if args.production_mesh or args.multi_pod:
        mesh = _production_mesh(ap, args, on_cpu)
    cfg = configs.get(args.arch, reduced=args.reduced or on_cpu)
    dc = DataConfig(vocab=cfg.vocab, global_batch=args.global_batch,
                    seq_len=args.seq_len)
    oc = AdamWConfig(lr_peak=args.lr, warmup_steps=max(1, args.steps // 20),
                     total_steps=args.steps)
    tc = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                     ckpt_dir=args.ckpt_dir, log_every=10,
                     microbatch=args.microbatch)
    out = Trainer(cfg, dc, oc, tc, mesh=mesh,
                  device=None if mesh is not None else args.device).run()
    if mesh is not None and torch.distributed.get_rank() != 0:
        return
    for s, l in out["losses"]:
        print(f"step {s:5d} loss {l:.4f}")
    print(f"done: step {out['final_step']} wall {out['seconds']:.1f}s")


if __name__ == "__main__":
    main()
