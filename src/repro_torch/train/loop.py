"""Training loop, in PyTorch (the port of ``repro.train.loop``): the train
step for every family and a restartable trainer.

``make_train_step(cfg, opt_cfg)`` builds the family's loss and step: a
plain function over the parameter tree that takes the gradient of every
leaf with ``torch.autograd.grad``, clips it by the global norm and steps
AdamW in place (``train.optimizer``). ``Trainer`` wires the data
(``data.pipeline``: batches are a pure function of the step), the
checkpoints (``train.checkpoint``: the reference's on-disk format, atomic,
written on a thread), resume and restart after a failure.

With ``mesh`` (a ``DeviceMesh``) the step runs on DTensors: params and
moments placed by ``sharding.param_sharding_rules`` (FSDP x TP, experts
over "model"), every batch entry sharded over the batch axes, and each
microbatch chunk constrained to ``(None, "batch", ...)`` as the
reference's are, so a chunk never gathers the batch. Gradients come back
in their param's placements (a reduce-scatter where a rank holds part of
the sum). ``Trainer(mesh=)`` places its params, restores checkpoints onto
the mesh and shards each batch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import sharding as SH
from ..core.engine import resolve_device
from ..data.pipeline import DataConfig, SyntheticTokens
from ..models import encdec as ED
from ..models import layers as L
from ..models import lm as LM
from . import checkpoint as CKPT
from .optimizer import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                        clip_by_global_norm)

__all__ = ["cross_entropy", "make_forward", "make_loss", "make_train_step",
           "value_and_grad", "Trainer", "TrainConfig"]

# batch entries that index (tokens) or gather (labels): int64 on the device
_INDEX_KEYS = ("tokens", "labels")


def cross_entropy(logits, labels, mask=None):
    if SH.is_dtensor(logits):
        return _cross_entropy_split(logits, labels, mask)
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    if mask is None:
        return -torch.mean(ll)
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _cross_entropy_split(logits, labels, mask):
    """``cross_entropy`` of DTensor logits (B, S, V): each rank's block of
    the batch (the vocab gathered) as a region of plain tensors, whose
    mean, weighted by its share of the tokens (or masked sums), is a part
    of the whole batch's over the batch axes."""
    mesh = logits.device_mesh
    spec = SH.logical_to_spec(mesh, ("batch", None, None),
                              tuple(logits.shape))
    pl = SH.placements(mesh, spec)
    lg = SH.local_region(logits, spec, pl)
    lb = SH.local_region(SH.constrain(labels, mesh, ("batch", None)),
                         spec[:2], SH.placements(mesh, spec[:2]))
    parts = SH.axes_of(spec[0])
    total = SH.placements(mesh, ())

    def whole(part):       # the sum of every rank's part
        return SH.from_region(part, mesh, SH.placements(mesh, (), parts),
                              ()).redistribute(mesh, total)
    if mask is None:
        share = lb.numel() / labels.numel()
        return whole(cross_entropy(lg, lb) * share).to_local()
    mk = SH.local_region(SH.constrain(mask, mesh, ("batch", None)),
                         spec[:2], SH.placements(mesh, spec[:2]))
    logp = torch.log_softmax(lg.float(), dim=-1)
    ll = torch.gather(logp, -1, lb[..., None])[..., 0]
    num = whole(torch.sum(ll * mk)).to_local()
    den = whole(torch.sum(mk)).to_local()
    return -num / torch.clamp(den, min=1.0)


def make_forward(cfg: LM.ArchCfg, mesh=None) -> Callable:
    """batch dict -> logits, per family."""
    if cfg.family == "encdec":
        def fwd(params, batch):
            return ED.encdec_forward(params, batch["frames"],
                                     batch["tokens"], cfg, mesh=mesh)
        return fwd
    if cfg.family == "vlm":
        def fwd(params, batch):
            return LM.lm_forward(params, batch["tokens"], cfg, mesh=mesh,
                                 prefix_embeds=batch["patch_embeds"])
        return fwd

    def fwd(params, batch):
        return LM.lm_forward(params, batch["tokens"], cfg, mesh=mesh)
    return fwd


def make_loss(cfg: LM.ArchCfg, mesh=None) -> Callable:
    fwd = make_forward(cfg, mesh)

    def loss_fn(params, batch):
        logits = fwd(params, batch)
        labels = batch["labels"]
        if cfg.family == "vlm":
            # prefix positions carry no LM loss
            logits = logits[:, cfg.prefix_len:, :]
        return cross_entropy(logits, labels)
    return loss_fn


def batch_on(batch: Dict[str, Any], device, mesh=None, *,
             microbatch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``: token
    ids and labels int64, the stub embeddings in their own dtype. With
    ``microbatch`` each entry is cut into ``(microbatch, B / microbatch,
    ...)`` chunks first. On ``mesh`` (the whole batch given on every
    rank) each entry is sharded over the batch axes: axis 0, or a
    chunk's batch axis 1 (the reference's ``(None, "batch", ...)``)."""
    out = {}
    for k, v in batch.items():
        t = (v.full_tensor() if SH.is_dtensor(v)
             else torch.as_tensor(v)).to(device)
        t = t.long() if k in _INDEX_KEYS else t
        lead = 0
        if microbatch and microbatch > 1:
            t = t.reshape((microbatch, t.shape[0] // microbatch)
                          + t.shape[1:])
            lead = 1
        if mesh is not None:
            t = SH.place(mesh, t, SH.batch_spec(mesh, t.shape, lead))
        out[k] = t
    return out


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A replicated DTensor's value (the loss) as a plain tensor."""
    return t.full_tensor() if SH.is_dtensor(t) else t


def value_and_grad(loss_fn: Callable, params, batch, mesh=None):
    """(the loss, the gradient of every leaf of ``params``, a tree of
    contiguous tensors of the leaves' dtypes). The params are not
    modified; autograd runs on detached aliases of them. On ``mesh``
    each gradient is a DTensor in its param's placements and the loss a
    plain tensor."""
    with torch.enable_grad(), SH.on_mesh(mesh):
        live = L.tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, L.leaves(live))
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if SH.is_dtensor(p) else g
                 for g, p in zip(grads, L.leaves(params))]
    del live
    return _plain(loss.detach()), L.unflatten_like(
        params, [g.contiguous() for g in grads])


def make_train_step(cfg: LM.ArchCfg, opt_cfg: AdamWConfig, mesh=None, *,
                    microbatch: Optional[int] = None) -> Callable:
    """(params, opt_state, batch, step) -> (params, opt_state, metrics),
    params and state updated in place.

    ``microbatch``: optional gradient-accumulation factor. The batch is
    split along axis 0 into ``(microbatch, B / microbatch, ...)`` chunks,
    run one after the other, their gradients summed in float32 (bf16 with
    ``cfg.accum_bf16``) and divided by the factor, as is the loss:
    activation memory divides by the factor at the same math.

    ``mesh``: params and state are DTensors on it (placed by the rules);
    the batch is given whole, as numpy arrays or plain tensors, and
    sharded here."""
    loss_fn = make_loss(cfg, mesh)
    accum_dtype = torch.bfloat16 if cfg.accum_bf16 else torch.float32

    def step_fn(params, opt_state, batch, step):
        device = L.leaves(params)[0].device
        if microbatch and microbatch > 1:
            chunks = batch_on(batch, device, mesh, microbatch=microbatch)
            loss, grads = None, None
            for i in range(microbatch):
                with SH.on_mesh(mesh):
                    chunk = {k: c[i] for k, c in chunks.items()}
                l, g = value_and_grad(loss_fn, params, chunk, mesh)
                if grads is None:
                    loss = torch.zeros((), dtype=torch.float32,
                                       device=l.device) + l
                    grads = L.tree_map(lambda a: a.to(accum_dtype), g)
                else:
                    loss = loss + l
                    L.tree_map(lambda a, b: a.add_(b), grads, g)
                del g
            loss = loss / microbatch
            L.tree_map(lambda a: a.div_(microbatch), grads)
        else:
            loss, grads = value_and_grad(
                loss_fn, params, batch_on(batch, device, mesh), mesh)
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.clip_norm)
        params, opt_state = adamw_update(grads, opt_state, params, opt_cfg,
                                         step)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step_fn


# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainConfig:
    steps: int = 200
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    microbatch: Optional[int] = None
    seed: int = 0


class Trainer:
    """Restartable trainer. Construction is cheap; ``run`` resumes from the
    latest complete checkpoint automatically (fault tolerance: kill the
    process at any point and call run() again). Trains on the card unless
    ``device="cpu"`` is asked for; a fresh run draws its params from a
    CPU generator seeded with ``tc.seed`` and moves them to the device,
    so the card and the CPU start from the same params.

    ``mesh``: a ``DeviceMesh`` spanning the process group; every rank
    draws the same params and keeps its shards (``sharding.
    param_sharding_rules``), a checkpoint is restored onto the mesh,
    and each rank builds the whole batch and keeps its shard."""

    def __init__(self, cfg: LM.ArchCfg, data_cfg: DataConfig,
                 opt_cfg: AdamWConfig, tc: TrainConfig, *, mesh=None,
                 device=None):
        self.cfg, self.data_cfg, self.opt_cfg, self.tc = (
            cfg, data_cfg, opt_cfg, tc)
        self.mesh = mesh
        self.device = resolve_device(
            device if mesh is None else mesh.device_type)
        if cfg.family == "encdec":
            self.spec = ED.encdec_spec(cfg, cfg.n_enc, cfg.n_dec)
        else:
            self.spec = LM.lm_spec(cfg)
        self.data = SyntheticTokens(data_cfg)
        self._step_fn = make_train_step(cfg, opt_cfg, mesh,
                                        microbatch=tc.microbatch)
        self.ckpt = (CKPT.Checkpointer(tc.ckpt_dir)
                     if tc.ckpt_dir else None)

    def _specs(self):
        """The params' specs on the mesh."""
        return SH.param_sharding_rules(self.mesh,
                                       L.abstract_params(self.spec),
                                       L.axes_tree(self.spec))

    def _init_state(self):
        # drawn on the CPU, then moved: the same params on any device, as
        # the reference's PRNG draws them (a CUDA generator draws others)
        gen = torch.Generator().manual_seed(self.tc.seed)
        params = L.tree_map(lambda t: t.to(self.device),
                            L.init_params(self.spec, generator=gen))
        if self.mesh is not None:
            params = SH.place_tree(self.mesh, params, self._specs())
        return params, adamw_init(params)

    def _template(self):
        """The state's keys, shapes and dtypes on ``meta`` (no
        allocation): what a checkpoint restores into."""
        params = L.abstract_params(self.spec)
        return {"params": params, "opt": adamw_init(params)}

    def _shardings(self):
        """The template's shardings on the mesh (None without one)."""
        if self.mesh is None:
            return None
        named = L.tree_map(lambda s: SH.NamedSharding(self.mesh, s),
                           self._specs())
        return {"params": named,
                "opt": AdamWState(m=named, v=named, count=None)}

    def _make_batch(self, step: int) -> Dict[str, Any]:
        b = self.data.batch(step)
        cfg = self.cfg
        if cfg.family == "vlm":
            n = b["tokens"].shape[0]
            rng = np.random.default_rng([step, 7])
            b["patch_embeds"] = torch.from_numpy(rng.standard_normal(
                (n, cfg.prefix_len, cfg.d_model), dtype=np.float32)
            ).to(torch.bfloat16)
        if cfg.family == "encdec":
            n = b["tokens"].shape[0]
            rng = np.random.default_rng([step, 11])
            enc_len = min(self.data_cfg.seq_len, 64)
            b["frames"] = torch.from_numpy(rng.standard_normal(
                (n, enc_len, cfg.d_model), dtype=np.float32)
            ).to(torch.bfloat16)
        return b

    def run(self, *, fail_at_step: Optional[int] = None) -> Dict[str, Any]:
        """Train to tc.steps, resuming from the latest checkpoint.
        ``fail_at_step`` injects a crash (for fault-tolerance tests)."""
        restored, start = None, 0
        if self.ckpt:
            restored, meta = CKPT.restore_latest(
                self.tc.ckpt_dir, self._template(), device=self.device,
                shardings=self._shardings())
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            start = int(meta["step"]) + 1
        else:
            params, opt_state = self._init_state()
        losses = []
        t0 = time.time()
        try:
            for step in range(start, self.tc.steps):
                if fail_at_step is not None and step == fail_at_step:
                    raise RuntimeError(f"injected failure at step {step}")
                batch = self._make_batch(step)
                params, opt_state, metrics = self._step_fn(
                    params, opt_state, batch, step)
                if (step % self.tc.log_every == 0
                        or step == self.tc.steps - 1):
                    losses.append((step, float(metrics["loss"])))
                if self.ckpt and (step % self.tc.ckpt_every == 0
                                  or step == self.tc.steps - 1):
                    self.ckpt.save_async(
                        step, {"params": params, "opt": opt_state},
                        extra={"arch": self.cfg.name})
        finally:
            # also on a failure: a write left running would race the
            # next run's writes into the same directory
            if self.ckpt:
                self.ckpt.wait()
        return {"losses": losses, "params": params,
                "seconds": time.time() - t0, "final_step": self.tc.steps - 1}
