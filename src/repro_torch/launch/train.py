"""Training launcher (the port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --steps 100 --ckpt-dir /tmp/ckpt            # full config, the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --device cpu --steps 3            # reduced config, CPU

Trains on one card, or on the CPU with ``--device cpu``. The config is
the full one unless ``--reduced`` is given or the run is on the CPU (the
reference shrinks it whenever it sees a single device, a rule written for
its CPU box). The loop resumes from the latest complete checkpoint
automatically: relaunch after any failure. There is no mesh yet:
``--production-mesh`` and ``--multi-pod`` are ROADMAP §1 item 4.3.
"""
from __future__ import annotations

import argparse

from .. import configs
from ..data.pipeline import DataConfig
from ..train.loop import TrainConfig, Trainer
from ..train.optimizer import AdamWConfig


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
                    help="not ported: ROADMAP item 4.3")
    ap.add_argument("--multi-pod", action="store_true",
                    help="not ported: ROADMAP item 4.3")
    args = ap.parse_args(argv)
    if args.production_mesh or args.multi_pod:
        ap.error("--production-mesh and --multi-pod need the sharding "
                 "slice (ROADMAP §1 item 4.3), not yet ported: the port "
                 "trains on one card")

    on_cpu = args.device is not None and args.device.startswith("cpu")
    cfg = configs.get(args.arch, reduced=args.reduced or on_cpu)
    dc = DataConfig(vocab=cfg.vocab, global_batch=args.global_batch,
                    seq_len=args.seq_len)
    oc = AdamWConfig(lr_peak=args.lr, warmup_steps=max(1, args.steps // 20),
                     total_steps=args.steps)
    tc = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                     ckpt_dir=args.ckpt_dir, log_every=10,
                     microbatch=args.microbatch)
    out = Trainer(cfg, dc, oc, tc, device=args.device).run()
    for s, l in out["losses"]:
        print(f"step {s:5d} loss {l:.4f}")
    print(f"done: step {out['final_step']} wall {out['seconds']:.1f}s")


if __name__ == "__main__":
    main()
