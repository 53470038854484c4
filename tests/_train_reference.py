"""JAX's train step on the reduced configs, shared by the
tests/test_torch_train_*.py files: one step from the reference's params
and optimizer state on one batch (the loss, the raw gradients, the grad
norm, the updated params and moments), cached per (arch, dtype) within a
test process, and the port's step from the same params, state and batch.

Two precisions:

``f32``  params in float32 with both packages' ``grad_cast_bf16`` made
         the identity for the run. The reference's own cast cannot run in
         float32: its backward returns a bf16 cotangent for a float32
         primal, and JAX's autodiff then raises (a TypeError or an
         AssertionError on every reduced config). The port rounds the
         cotangent to bf16 and keeps it float32 (torch casts a
         ``Function``'s gradient back to its input's dtype). With the cast
         as the identity on both sides the float32 backward of every op
         is compared at ``rtol = atol = 1e-4``; the rounding itself is
         tested apart (ROADMAP §3).
``bf16`` the serving and training dtype, the real cast on both sides:
         the loss at the reference's 0.05, the grad norm at 1 %, each
         gradient and moment leaf by its relative norm gap
         (``BF16_REL``), each param by the step it took
         (``assert_bf16_update``). xlstm-350m's reference (``EAGER_BF16``) runs jitted with XLA's
         ``--xla_allow_excess_precision=false`` in a subprocess, in 20 s
         where the eager backward takes minutes. That run lies close to
         JAX's eager one (loss 4.4e-3 apart, grad norm 0.37 %, every
         gradient leaf at a cosine >= 0.9996); the compiled default, which
         keeps bf16 chains in float32 inside a fusion, lies 0.042, 24.8 %
         and 0.304 from it.

``python tests/_train_reference.py [--eager]`` (JAX on the CPU,
``PYTHONPATH=src``) prints the gaps the tolerances below were set from.
"""
import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _lm_reference import EAGER_BF16, F32
from repro import configs as JC
from repro.models import encdec as JED
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.train import loop as JLOOP
from repro.train import optimizer as JOPT
from repro_torch import configs as TC
from repro_torch.convert import adamw_state_from_numpy, lm_params_from_numpy
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.train import loop as TLOOP
from repro_torch.train import optimizer as TOPT

B, S = 4, 16
STEP = 1          # inside the warm-up: lr = lr_peak / 3
OPT = dict(lr_peak=1e-3, warmup_steps=3, total_steps=30)
# the reference's own tolerance for a bf16 step (tests/test_train.py:97-103)
BF16_ATOL = 0.05
# xlstm-350m in bf16: 16 layers of exponentially gated recurrence in bf16
# carry each side's rounding far. On this batch the port lies 0.074 from
# the reference's loss, 0.9 % from its grad norm, and each gradient leaf
# at a cosine >= 0.983 from its; the reference's own compiled default lies
# 0.042, 24.8 % and down to a cosine of 0.304 from the same run. Held to
# about twice the port's gap: the loss within 0.15, the grad norm 2 %,
# each gradient and moment leaf a cosine of 0.96
XLSTM_BF16 = dict(loss_atol=0.15, gnorm_rtol=0.02, cosine=0.96)
# xlstm-350m in float32: the same recurrence amplifies float32 rounding in
# the backward. The reference's own jitted and eager gradients differ by
# up to 1.9e-4, the port's lie up to 8.4e-4 from the jitted ones, and the
# port's on the card up to 7.9e-4 from its own on the CPU (PERF.md):
# its gradients (and loss, grad norm, moments) are held at atol 1.5e-3,
# 1.8x the largest
F32_XLSTM_GRAD = dict(rtol=1e-4, atol=1.5e-3)
# the bf16 grad norm of the other configs (measured within 0.11 %)
BF16_GNORM_RTOL = 0.01
# bf16 gradients, first and second moments, leaf by leaf as ||port - ref||
# / ||ref|| (``rel_gap``): measured at most 0.028 (gradients, m) and 0.037
# (v) on the other configs, held at 0.06. The updated params are held as
# steps (``assert_bf16_update``), by AdamW's own algebra.
BF16_REL = 0.06
# deepseek-moe-16b's gaps are 0.093 / 0.094 / 0.124, largest in the
# routed experts' leaves (we_gate, then we_down and we_up): bf16 router
# scores near a tie can send a token to another expert on one side, and
# that expert's whole gradient moves. Held at 0.2
BF16_REL_LOOSE = {"deepseek-moe-16b": 0.2}

_REFS = {}
_ENV_FLAG = "--xla_allow_excess_precision=false"


@jax.custom_vjp
def _identity(x):
    return x


_identity.defvjp(lambda x: (x, None), lambda _, g: (g,))


@contextlib.contextmanager
def exact_float32():
    """Both packages' ``grad_cast_bf16`` as the identity, for a float32
    run (the reference's raises in float32; see the module docstring)."""
    saved = JL.grad_cast_bf16, TL.grad_cast_bf16, TMOE.grad_cast_bf16
    JL.grad_cast_bf16 = _identity
    TL.grad_cast_bf16 = TMOE.grad_cast_bf16 = lambda x: x
    try:
        yield
    finally:
        JL.grad_cast_bf16, TL.grad_cast_bf16, TMOE.grad_cast_bf16 = saved


def precision(dtype):
    return exact_float32() if dtype == "f32" else contextlib.nullcontext()


def opt_cfgs():
    return JOPT.AdamWConfig(**OPT), TOPT.AdamWConfig(**OPT)


def flat(tree, prefix=""):
    """Nested dicts -> {"a//b": leaf}, in sorted key order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}//"))
        return out
    return {prefix[:-2]: tree}


def numpy_batch(cfg, dtype):
    """SyntheticTokens' batch 0 and the family's stub embeddings in the
    params' dtype's numpy form (float32; bf16 is cast on each side)."""
    b = SyntheticTokens(DataConfig(vocab=cfg.vocab, global_batch=B,
                                   seq_len=S)).batch(0)
    rng = np.random.default_rng(5)
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model), dtype=np.float32)
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal((B, S, cfg.d_model),
                                          dtype=np.float32)
    return b


_EMBEDS = ("patch_embeds", "frames")


def jax_batch(batch, dtype):
    dt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    return {k: jnp.asarray(v, dt) if k in _EMBEDS else v
            for k, v in batch.items()}


def torch_batch(batch, dtype):
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    return {k: torch.from_numpy(v).to(dt) if k in _EMBEDS else v
            for k, v in batch.items()}


def jax_params(cfg, dtype):
    spec = (JED.encdec_spec(cfg, cfg.n_enc, cfg.n_dec)
            if cfg.family == "encdec" else JLM.lm_spec(cfg))
    p = JL.init_params(jax.random.PRNGKey(0), spec)
    if dtype == "f32":
        p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    return p


def reference(arch, dtype):
    """The reference's step for (arch, dtype): a dict of numpy arrays and
    trees (params, state, batch, loss, grads, grad_norm, new_params,
    m, v)."""
    key = (arch, dtype)
    if key not in _REFS:
        if dtype == "bf16" and arch in EAGER_BF16:
            _REFS[key] = _flagged_run(arch, dtype)
        else:
            _REFS[key] = _run(arch, dtype)
    return _REFS[key]


def _run(arch, dtype):
    cfg = JC.get(arch, reduced=True)
    params = jax_params(cfg, dtype)
    state = JOPT.adamw_init(params)
    batch = numpy_batch(cfg, dtype)
    oc, _ = opt_cfgs()
    loss_fn = JLOOP.make_loss(cfg)

    def step(params, state, batch, step):
        # make_train_step's body, with the raw gradients returned too
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        clipped, gnorm = JOPT.clip_by_global_norm(grads, oc.clip_norm)
        new_p, new_s = JOPT.adamw_update(clipped, state, params, oc, step)
        return loss, grads, gnorm, new_p, new_s

    host = jax.tree.map(np.asarray, (params, state))
    with precision(dtype):
        loss, grads, gnorm, new_p, new_s = jax.jit(step)(
            params, state, jax_batch(batch, dtype), jnp.int32(STEP))
    return {"params": host[0], "state": host[1], "batch": batch,
            "loss": np.asarray(loss), "grads": jax.tree.map(np.asarray, grads),
            "grad_norm": np.asarray(gnorm),
            "new_params": jax.tree.map(np.asarray, new_p),
            "m": jax.tree.map(np.asarray, new_s.m),
            "v": jax.tree.map(np.asarray, new_s.v)}


_SCRIPT = r"""
import sys
sys.path[:0] = [{src!r}, {tests!r}]
import numpy as np
import _train_reference as R
ref = R._run({arch!r}, {dtype!r})
out = {{"loss": ref["loss"], "grad_norm": ref["grad_norm"]}}
for name in ("params", "grads", "new_params", "m", "v"):
    for k, a in R.flat(ref[name]).items():
        out[name + "/" + k] = np.asarray(a, np.float32)
np.savez({out!r}, **out)
"""


def _unflat(flat_items):
    tree = {}
    for k, a in flat_items.items():
        node = tree
        parts = k.split("//")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    return tree


def _flagged_run(arch, dtype):
    """``_run`` in a subprocess whose XLA rounds every bf16 op (see the
    module docstring). Leaves come back as float32 numpy; bf16 params are
    cast back to bf16 on the port's side."""
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ref.npz")
        script = _SCRIPT.format(src=os.path.join(os.path.dirname(here), "src"),
                                tests=here, arch=arch, dtype=dtype, out=out)
        env = {**os.environ, "XLA_FLAGS": _ENV_FLAG, "JAX_PLATFORMS": "cpu",
               "OMP_NUM_THREADS": "1"}
        proc = subprocess.run([sys.executable, "-c", script], env=env,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with np.load(out) as z:
            got = {k: z[k] for k in z.files}
    cfg = JC.get(arch, reduced=True)
    ref = {"loss": got["loss"], "grad_norm": got["grad_norm"],
           "batch": numpy_batch(cfg, dtype)}
    for name in ("params", "grads", "new_params", "m", "v"):
        ref[name] = _unflat({k.split("/", 1)[1]: a for k, a in got.items()
                             if k.startswith(name + "/")})
    ref["params"] = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                 ref["params"])
    host = jax.tree.map(np.asarray, JOPT.adamw_init(ref["params"]))
    ref["state"] = host
    return ref


def port_step(arch, ref, dtype, *, microbatch=None):
    """The port's step from the reference's params, state and batch on
    the CPU: (loss, raw grads, metrics, new params, new state)."""
    cfg = TC.get(arch, reduced=True)
    _, oc = opt_cfgs()
    params = lm_params_from_numpy(cfg, ref["params"], device="cpu")
    state = adamw_state_from_numpy(cfg, ref["state"], device="cpu")
    batch = TLOOP.batch_on(torch_batch(ref["batch"], dtype), "cpu")
    with precision(dtype):
        loss, grads = TLOOP.value_and_grad(TLOOP.make_loss(cfg), params,
                                           batch)
        step = TLOOP.make_train_step(cfg, oc, microbatch=microbatch)
        params, state, metrics = step(params, state, batch, STEP)
    return loss, grads, metrics, params, state


def port_mb(cfg, ref, dtype, microbatch):
    """The port's ``make_train_step`` for ``cfg`` with ``microbatch`` from
    the reference's params, state and batch on the CPU: (loss, grad norm,
    new params, m, v)."""
    _, oc = opt_cfgs()
    params = lm_params_from_numpy(cfg, ref["params"], device="cpu")
    state = adamw_state_from_numpy(cfg, ref["state"], device="cpu")
    with precision(dtype):
        params, state, mt = TLOOP.make_train_step(
            cfg, oc, microbatch=microbatch)(
                params, state, torch_batch(ref["batch"], dtype), STEP)
    return mt["loss"], mt["grad_norm"], params, state.m, state.v


def reference_mb(arch, dtype, microbatch, accum_bf16):
    """The reference's jitted ``make_train_step`` with ``microbatch`` (and
    ``accum_bf16``) from the same params, state and batch as
    ``reference(arch, dtype)``: (loss, grad norm, new params, m, v) in
    numpy."""
    import dataclasses
    cfg = dataclasses.replace(JC.get(arch, reduced=True),
                              accum_bf16=accum_bf16)
    ref = reference(arch, dtype)
    oc, _ = opt_cfgs()
    params = jax_params(cfg, dtype)
    with precision(dtype):
        p, s, mt = jax.jit(JLOOP.make_train_step(cfg, oc,
                                                 microbatch=microbatch))(
            params, JOPT.adamw_init(params), jax_batch(ref["batch"], dtype),
            jnp.int32(STEP))
    return (np.asarray(mt["loss"]), np.asarray(mt["grad_norm"]),
            jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s.m),
            jax.tree.map(np.asarray, s.v))


def f32_tol(arch):
    return F32_XLSTM_GRAD if arch in EAGER_BF16 else F32


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def assert_close_tree(got, want, **tol):
    g, w = flat(got), flat(want)
    assert list(g) == list(w)
    for k in w:
        np.testing.assert_allclose(_np(g[k]), _np(w[k]), err_msg=k, **tol)


def assert_cosine_tree(got, want, cosine):
    g, w = flat(got), flat(want)
    assert list(g) == list(w)
    for k in w:
        a, b = _np(g[k]).ravel(), _np(w[k]).ravel()
        cos = float(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30)
        assert cos >= cosine, (k, cos)


def rel_gap(a, b) -> float:
    """||a - b|| / ||b|| over one leaf, in float64 (0 where both are 0)."""
    a = _np(a).ravel().astype(np.float64)
    b = _np(b).ravel().astype(np.float64)
    d, n = float(np.linalg.norm(a - b)), float(np.linalg.norm(b))
    return 0.0 if d == 0 else (d / n if n else float("inf"))


def updates(new, old):
    """Each leaf's step, ``new - old`` in float32 (a flat dict)."""
    n, o = flat(new), flat(old)
    assert list(n) == list(o)
    return {k: _np(n[k]) - _np(o[k]) for k in o}


def max_rel_gap(got, want) -> float:
    """The largest per-leaf ``rel_gap`` of two trees."""
    g, w = flat(got), flat(want)
    assert list(g) == list(w)
    return max(rel_gap(g[k], w[k]) for k in w)


def assert_rel_tree(got, want, rel, what):
    g, w = flat(got), flat(want)
    assert list(g) == list(w)
    for k in w:
        gap = rel_gap(g[k], w[k])
        assert gap <= rel, (what, k, gap, rel)


def lr_at_step():
    _, oc = opt_cfgs()
    return float(TOPT.warmup_cosine(oc, STEP))


def assert_params_after_first_step(got, want, signal, tol):
    """Trouble spot 3: a first AdamW step moves each param by lr *
    sign(g) (plus weight decay), so an element whose gradient ``signal``
    (the reference's raw gradient, or its first moment) lies within the
    gradient tolerance of 0 may move the other way, 2 lr from the
    reference's; every other element must agree to float32 rounding.
    Returns the share of such elements."""
    two_lr = 2 * lr_at_step() * (1 + 1e-3)
    g, w, s = flat(got), flat(want), flat(signal)
    unsure = total = 0
    for k in w:
        a, b, sig = _np(g[k]), _np(w[k]), _np(s[k])
        near0 = np.abs(sig) <= tol["atol"] + tol["rtol"] * np.abs(sig)
        allowed = np.where(near0, two_lr, 0.0) + 1e-6 + 1e-6 * np.abs(b)
        bad = np.abs(a - b) > allowed
        assert not bad.any(), (k, np.abs(a - b)[bad].max())
        unsure += int(near0.sum())
        total += near0.size
    return unsure / total


def bf16_ulp(x):
    """One bf16 ulp at each |x| (numpy float32; zero counts as the least
    normal)."""
    x = np.maximum(np.abs(x), np.float32(2.0 ** -126)).astype(np.float32)
    return np.exp2(np.floor(np.log2(x)) - 7).astype(np.float32)


def _bf16_steps(new, old, want_new, got_m, want_m):
    """Per leaf, after a first AdamW step: (|step - the reference's
    step|, what ``assert_bf16_update`` allows there)."""
    _, oc = opt_cfgs()
    lr = lr_at_step() * (1 + 1e-3)
    n, o, w = flat(new), flat(old), flat(want_new)
    gm, wm = flat(got_m), flat(want_m)
    assert list(n) == list(o) == list(w) == list(gm) == list(wm)
    for k in o:
        a, b, old_k = _np(n[k]), _np(w[k]), _np(o[k])
        # m = (1 - b1) g at the first step: each side's clipped gradient
        g1, g2 = _np(gm[k]) / (1 - oc.b1), _np(wm[k]) / (1 - oc.b1)
        small = np.minimum(np.abs(g1), np.abs(g2))
        frac = np.where(np.sign(g1) != np.sign(g2), 2.0,
                        oc.eps / (small + oc.eps))
        yield (k, np.abs((a - old_k) - (b - old_k)),
               bf16_ulp(np.maximum(np.abs(a), np.abs(b))) + lr * frac,
               frac == 2.0)


def assert_bf16_update(new, old, want_new, got_m, want_m):
    """Trouble spot 3 in bf16: each param's step (``new - old``) against
    the reference's (``want_new - old``) after a first AdamW step, from
    each side's first moments ``got_m`` and ``want_m``. Such a step moves a
    param by lr * g / (|g| + eps) (and the decay, the same on both sides),
    rounded to bf16. So the two steps may differ by one bf16 ulp of the
    new value and, where the gradients differ in sign, 2 lr, else lr *
    eps / (the smaller |g| + eps): a fraction of lr only where a gradient
    is within a few eps of 0. The gradients and moments themselves are
    held apart (``BF16_REL``). A step that does not move the params, or
    moves them by the wrong amount, fails wherever lr exceeds an ulp.
    Returns the share of elements whose signs differ."""
    flipped = total = 0
    for k, diff, allowed, flip in _bf16_steps(new, old, want_new, got_m,
                                              want_m):
        bad = diff > allowed
        assert not bad.any(), (k, diff[bad].max(), allowed[bad].max())
        flipped += int(flip.sum())
        total += flip.size
    return flipped / total


def bf16_update_reading(new, old, want_new, got_m, want_m):
    """What ``assert_bf16_update`` sees: (the largest step difference over
    what it allows, the share of elements whose signs differ)."""
    worst, flipped, total = 0.0, 0, 0
    for _, diff, allowed, flip in _bf16_steps(new, old, want_new, got_m,
                                              want_m):
        worst = max(worst, float((diff / allowed).max()))
        flipped += int(flip.sum())
        total += flip.size
    return worst, flipped / total


def check_step(arch, dtype):
    """The port's step against the reference's for (arch, dtype): the
    loss, the grad norm, every gradient leaf, the moments and the params
    (see the module docstring for the tolerances)."""
    ref = reference(arch, dtype)
    loss, grads, metrics, params, state = port_step(arch, ref, dtype)
    assert int(state.count) == 1
    if dtype == "f32":
        tol = f32_tol(arch)
        for got in (loss, metrics["loss"]):
            np.testing.assert_allclose(float(got), ref["loss"], **tol)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   ref["grad_norm"], **tol)
        assert_close_tree(grads, ref["grads"], **tol)
        assert_close_tree(state.m, ref["m"], **tol)
        assert_close_tree(state.v, ref["v"], **tol)
        assert_params_after_first_step(params, ref["new_params"],
                                       ref["grads"], tol)
        return
    xl = arch in EAGER_BF16
    for got in (loss, metrics["loss"]):
        assert abs(float(got) - float(ref["loss"])) <= (
            XLSTM_BF16["loss_atol"] if xl else BF16_ATOL)
    np.testing.assert_allclose(
        float(metrics["grad_norm"]), ref["grad_norm"],
        rtol=XLSTM_BF16["gnorm_rtol"] if xl else BF16_GNORM_RTOL)
    for got, want, what in ((grads, ref["grads"], "grads"),
                            (state.m, ref["m"], "m"),
                            (state.v, ref["v"], "v")):
        if xl:
            assert_cosine_tree(got, want, XLSTM_BF16["cosine"])
        else:
            assert_rel_tree(got, want, BF16_REL_LOOSE.get(arch, BF16_REL),
                            what)
    assert_bf16_update(params, ref["params"], ref["new_params"], state.m,
                       ref["m"])


# --- the readings the tolerances above were set from -----------------------

@jax.custom_vjp
def _round_keep(x):
    return x


_round_keep.defvjp(lambda x: (x, None),
                   lambda _, g: (g.astype(jnp.bfloat16).astype(g.dtype),))


@contextlib.contextmanager
def rounded_float32():
    """The reference's ``grad_cast_bf16`` rounding its cotangent to bf16
    and keeping the primal's dtype (the port's rule), for a float32 run
    with the port's own cast."""
    saved = JL.grad_cast_bf16
    JL.grad_cast_bf16 = _round_keep
    try:
        yield
    finally:
        JL.grad_cast_bf16 = saved


def _gaps(got, want):
    """(max |diff|, max |diff| over the leaf's largest |value|, the least
    cosine, unequal elements, elements) over two gradient trees."""
    g, w = flat(got), flat(want)
    out = [0.0, 0.0, 1.0, 0, 0]
    for k in w:
        a, b = _np(g[k]).ravel(), _np(w[k]).ravel()
        d = float(np.abs(a - b).max())
        cos = float(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30)
        out = [max(out[0], d), max(out[1], d / (np.abs(b).max() + 1e-30)),
               min(out[2], cos), out[3] + int((a != b).sum()),
               out[4] + a.size]
    return out


def report(eager: bool = False):
    """Print, for every reduced config, how far the port's step lies from
    the reference's: float32 with the cast as the identity (the tests'
    rule), float32 with the cast rounding on both sides, and bf16; then
    xlstm-350m's reference against itself (its compiled default against
    the run with XLA's excess precision off, in bf16; with ``eager``, that
    run against the eager one, and its jitted float32 gradients against
    its eager ones: minutes on a CPU)."""
    def line(arch, mode, loss, gnorm, grads, ref):
        d, rel, cos, unequal, n = _gaps(grads, ref["grads"])
        dloss = abs(float(loss) - float(ref["loss"]))
        want = float(ref["grad_norm"])
        print(f"{arch:20s} {mode:12s} loss {dloss:.3e} grad_norm_rel "
              f"{abs(float(gnorm) - want) / want:.3e} grad_max_abs {d:.3e} "
              f"grad_max_rel {rel:.3e} grad_rel_gap "
              f"{max_rel_gap(grads, ref['grads']):.3e} cosine_min {cos:.6f} "
              f"unequal {unequal}/{n}", flush=True)

    def bf16_line(arch, mode, params, m, v, ref, want_m, want_v, want_new):
        worst, flipped = bf16_update_reading(params, ref["params"],
                                             want_new, m, want_m)
        print(f"{arch:20s} {mode:12s} m_rel {max_rel_gap(m, want_m):.3e} "
              f"v_rel {max_rel_gap(v, want_v):.3e} step_over_allowed "
              f"{worst:.4f} sign_differs {flipped:.4f}", flush=True)

    for arch in TC.ARCH_IDS:
        for dtype in ("f32", "bf16"):
            ref = reference(arch, dtype)
            loss, grads, m, params, state = port_step(arch, ref, dtype)
            line(arch, dtype, loss, m["grad_norm"], grads, ref)
            if dtype == "bf16":
                bf16_line(arch, "bf16-state", params, state.m, state.v, ref,
                          ref["m"], ref["v"], ref["new_params"])
            if dtype == "f32":
                # trouble spot 3: the share of params whose gradient lies
                # within the tolerance of 0 (their step may flip sign)
                share = assert_params_after_first_step(
                    params, ref["new_params"], ref["grads"], f32_tol(arch))
                diff = max(float(np.abs(_np(a) - _np(b)).max()) for a, b in
                           zip(flat(params).values(),
                               flat(ref["new_params"]).values()))
                print(f"{arch:20s} {'f32-params':12s} near_zero_share "
                      f"{share:.4f} param_max_abs {diff:.3e} two_lr "
                      f"{2 * lr_at_step():.3e}", flush=True)
        if arch in EAGER_BF16:
            continue
        with rounded_float32():
            ref = _run_rounded(arch)
        cfg = TC.get(arch, reduced=True)
        params = lm_params_from_numpy(cfg, ref["params"], device="cpu")
        batch = TLOOP.batch_on(torch_batch(ref["batch"], "f32"), "cpu")
        loss, grads = TLOOP.value_and_grad(TLOOP.make_loss(cfg), params,
                                           batch)
        gnorm = torch.sqrt(sum((g * g).sum() for g in TL.leaves(grads)))
        line(arch, "f32-rounded", loss, gnorm, grads, ref)
    import dataclasses
    arch = "qwen3-4b"
    cfg, ref = TC.get(arch, reduced=True), reference(arch, "bf16")
    four = port_mb(cfg, ref, "bf16", 4)
    for mode, got, want in (
            ("bf16-mb4-vs-1", four, port_mb(cfg, ref, "bf16", None)),
            ("bf16-mb4-ref", four, reference_mb(arch, "bf16", 4, False)),
            ("bf16-mb4-acc", port_mb(dataclasses.replace(cfg, accum_bf16=True),
                                     ref, "bf16", 4),
             reference_mb(arch, "bf16", 4, True))):
        print(f"{arch:20s} {mode:12s} loss "
              f"{abs(float(got[0]) - float(want[0])):.3e} grad_norm_rel "
              f"{abs(float(got[1]) - float(want[1])) / float(want[1]):.3e}",
              flush=True)
        bf16_line(arch, mode, got[2], got[3], got[4], ref, want[3], want[4],
                  want[2])
    arch = EAGER_BF16[0]
    flagged, jitted = reference(arch, "bf16"), _run(arch, "bf16")
    line(arch, "ref-jit-bf16", jitted["loss"], jitted["grad_norm"],
         jitted["grads"], flagged)
    if eager:
        with jax.disable_jit():
            ref = _run(arch, "bf16")
        line(arch, "ref-flag-eager", flagged["loss"], flagged["grad_norm"],
             flagged["grads"], ref)
        with exact_float32(), jax.disable_jit():
            ref = _run(arch, "f32")
        jit = reference(arch, "f32")
        line(arch, "ref-jit-f32", jit["loss"], jit["grad_norm"],
             jit["grads"], ref)


def _run_rounded(arch):
    """``_run`` in float32 with the reference's cast rounding (inside
    ``rounded_float32``): ``precision`` would make it the identity."""
    cfg = JC.get(arch, reduced=True)
    params = jax_params(cfg, "f32")
    batch = numpy_batch(cfg, "f32")
    loss_fn = JLOOP.make_loss(cfg)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        params, jax_batch(batch, "f32"))
    gnorm = np.sqrt(sum(float(np.sum(np.square(np.asarray(g))))
                        for g in jax.tree.leaves(grads)))
    return {"params": jax.tree.map(np.asarray, params), "batch": batch,
            "loss": np.asarray(loss), "grad_norm": np.asarray(gnorm),
            "grads": jax.tree.map(np.asarray, grads)}


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_train_reference.py \
    #     [--eager]
    torch.set_num_threads(1)      # as the test files run
    report(eager="--eager" in sys.argv)
