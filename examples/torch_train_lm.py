"""End-to-end training on the PyTorch port: train a ~100M-parameter
qwen3-family model for a few hundred steps on the synthetic pipeline,
with checkpointing — kill the process at any step and re-run to resume
(fault tolerance demo).

The twin of ``examples/train_lm.py`` over ``repro_torch``: the same
flags, config and printed lines, plus ``--device``; its checkpoints go
to a directory of their own by default.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] \\
      [--d-model 512] [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.lm import num_params
from repro_torch.train.loop import TrainConfig, Trainer
from repro_torch.train.optimizer import AdamWConfig


def setup(argv=None, device=None):
    """Parse the flags; return them with the run's model, data, optimizer
    and training configs. A ``--device`` flag wins over ``device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    # a directory of its own: the port restores the reference's
    # checkpoints, so sharing examples/train_lm.py's would resume its run
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=device,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # ~100M params: d=512, 8 layers, vocab 32k (reduced family config)
    cfg = configs.get(args.arch, reduced=True)
    cfg = dataclasses.replace(
        cfg, d_model=args.d_model, n_heads=8, n_kv=4, head_dim=64,
        d_ff=args.d_model * 4, vocab=32768, repeats=args.layers,
        q_chunk=128, kv_chunk=128)
    dc = DataConfig(vocab=cfg.vocab, global_batch=args.batch,
                    seq_len=args.seq)
    oc = AdamWConfig(lr_peak=3e-4, warmup_steps=20, total_steps=args.steps)
    tc = TrainConfig(steps=args.steps, ckpt_every=50,
                     ckpt_dir=args.ckpt_dir, log_every=10)
    return args, cfg, dc, oc, tc


def main(argv=None, device=None):
    """Train as the flags say; return the Trainer's output (``losses``,
    ``final_step``, ``seconds``) and the config's parameter count
    (``n_params``)."""
    args, cfg, dc, oc, tc = setup(argv, device)
    n_params = num_params(cfg)
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M")
    out = Trainer(cfg, dc, oc, tc, device=args.device).run()
    print("loss curve:", [(s, round(l, 3)) for s, l in out["losses"]])
    print(f"trained to step {out['final_step']} in {out['seconds']:.0f}s")
    return dict(out, n_params=n_params)


if __name__ == "__main__":
    main()
