"""The port's training substrate (``repro_torch.train``, ``repro_torch.data``,
``repro_torch.launch.train``) against the JAX package's.

* Optimizer: ``warmup_cosine``, ``clip_by_global_norm`` and
  ``adamw_update`` equal the reference's on the same trees (float32 and
  bf16 leaves, steps in the warm-up and the cosine), and pass the
  reference's own cases (tests/test_train.py).
* Microbatching: ``microbatch=4`` matches the unsplit step and the
  reference's ``microbatch=4`` step, in float32 (the exact-float32 rule
  of tests/_train_reference.py), in bf16 and with bf16 accumulation.
* The Trainer: the loss falls over 25 steps; a crash at step 12 and a
  second ``run()`` reach step 19 with at most 3 checkpoints kept; a port
  Trainer resumes from a JAX Trainer's checkpoint and logs the JAX
  trainer's losses for the same steps; the VLM and enc-dec stub
  embeddings are the reference's bit for bit.
* Data: ``SyntheticTokens`` batches equal the reference's for every
  (seed, step, process) tried.
* The launcher runs in a subprocess on the CPU and refuses the mesh
  options.
"""
import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _train_reference as R
from repro import configs as JC
from repro.data import pipeline as JD
from repro.train import loop as JLOOP
from repro.train import optimizer as JOPT
from repro_torch import configs as TC
from repro_torch.data import pipeline as TD
from repro_torch.launch import train as TLAUNCH
from repro_torch.train import loop as TLOOP
from repro_torch.train import optimizer as TOPT

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


# --- optimizer ------------------------------------------------------------

SCHEDULES = [dict(lr_peak=1e-3, lr_min=1e-5, warmup_steps=10,
                  total_steps=100), {}]


@pytest.mark.parametrize("cfg", range(len(SCHEDULES)))
def test_warmup_cosine_matches_reference(cfg):
    jc, tc = (JOPT.AdamWConfig(**SCHEDULES[cfg]),
              TOPT.AdamWConfig(**SCHEDULES[cfg]))
    for step in [0, 1, 5, 9, 10, 11, 50, 99, 100, 101, 5000, 10_000, 20_000]:
        got = TOPT.warmup_cosine(tc, step)
        assert got.dtype == torch.float32 and got.ndim == 0
        np.testing.assert_allclose(float(got), float(JOPT.warmup_cosine(
            jc, jnp.int32(step))), rtol=1e-6, atol=0)


def test_warmup_cosine_schedule():
    """tests/test_train.py's schedule checks, on the port."""
    oc = TOPT.AdamWConfig(lr_peak=1e-3, lr_min=1e-5, warmup_steps=10,
                          total_steps=100)
    assert float(TOPT.warmup_cosine(oc, 0)) == 0.0
    assert abs(float(TOPT.warmup_cosine(oc, 10)) - 1e-3) < 1e-9
    assert float(TOPT.warmup_cosine(oc, 100)) <= 1e-5 + 1e-9
    lrs = [float(TOPT.warmup_cosine(oc, s)) for s in range(10, 101, 10)]
    assert all(a >= b for a, b in zip(lrs, lrs[1:]))


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((6, 40)) * scale).astype(np.float32),
            "b": (rng.standard_normal(40) * scale).astype(np.float32),
            "blk": {"k": (rng.standard_normal((3, 5, 7)) * scale
                          ).astype(np.float32)}}


def _to(tree, dtypes):
    """numpy tree -> (jax tree, torch tree) with leaf ``k`` in dtypes[k]."""
    j = {k: (jnp.asarray(v, dtypes[k][0]) if not isinstance(v, dict)
             else _to(v, dtypes)[0]) for k, v in tree.items()}
    t = {k: (_t(v, dtypes[k][1]) if not isinstance(v, dict)
             else _to(v, dtypes)[1]) for k, v in tree.items()}
    return j, t


F32_LEAVES = {"w": (jnp.float32, torch.float32),
              "b": (jnp.float32, torch.float32),
              "k": (jnp.float32, torch.float32)}
MIXED_LEAVES = {"w": (jnp.bfloat16, torch.bfloat16),
                "b": (jnp.float32, torch.float32),
                "k": (jnp.bfloat16, torch.bfloat16)}


def _check_clip(max_norm, mixed):
    dts = MIXED_LEAVES if mixed else F32_LEAVES
    jg, tg = _to(_tree(0, scale=3.0), dts)
    want, wnorm = JOPT.clip_by_global_norm(jg, max_norm)
    got, norm = TOPT.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    R.assert_close_tree(got, jax.tree.map(np.asarray, want),
                        rtol=2 ** -8 if mixed else 1e-6, atol=0)
    for k in ("w", "b"):
        assert got[k].dtype == dts[k][1]


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
@pytest.mark.parametrize("mixed", [False, True])
def test_clip_by_global_norm_matches_reference(max_norm, mixed):
    _check_clip(max_norm, mixed)


def _small_chunks(monkeypatch):
    """Split every leaf into 7-element chunks, as a full-width leaf is
    split into 2^24-element ones: the test trees' 240-, 40- and
    105-element leaves then span 35, 6 and 15 chunks."""
    monkeypatch.setattr(TOPT, "CHUNK", 7)
    assert [len(TOPT._chunks(torch.zeros(n))) for n in (240, 40, 105)] \
        == [35, 6, 15]


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
@pytest.mark.parametrize("mixed", [False, True])
def test_clip_by_global_norm_across_chunks_matches_reference(
        max_norm, mixed, monkeypatch):
    _small_chunks(monkeypatch)
    _check_clip(max_norm, mixed)


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, norm = TOPT.clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 10.0) < 1e-5
    total = float(torch.sqrt(sum((x ** 2).sum() for x in clipped.values())))
    assert abs(total - 1.0) < 1e-5


@pytest.mark.parametrize("mixed", [False, True])
def test_adamw_update_matches_reference(mixed):
    """Three consecutive steps from zero moments, in the warm-up and in
    the cosine, on the same gradients: params, moments and the count."""
    _check_adamw(mixed)


@pytest.mark.parametrize("mixed", [False, True])
def test_adamw_update_across_chunks_matches_reference(mixed, monkeypatch):
    _small_chunks(monkeypatch)
    _check_adamw(mixed)


def _check_adamw(mixed):
    dts = MIXED_LEAVES if mixed else F32_LEAVES
    jc, tc = (JOPT.AdamWConfig(lr_peak=1e-2, warmup_steps=3,
                               total_steps=40, weight_decay=0.3),
              TOPT.AdamWConfig(lr_peak=1e-2, warmup_steps=3,
                               total_steps=40, weight_decay=0.3))
    jp, tp = _to(_tree(1), dts)
    js, ts = JOPT.adamw_init(jp), TOPT.adamw_init(tp)
    for i, step in enumerate([1, 2, 30]):
        jg, tg = _to(_tree(10 + i, scale=0.1), dts)
        jp, js = JOPT.adamw_update(jg, js, jp, jc, jnp.int32(step))
        tp, ts = TOPT.adamw_update(tg, ts, tp, tc, step)
        assert int(ts.count) == int(js.count) == i + 1
        R.assert_close_tree(ts.m, jax.tree.map(np.asarray, js.m),
                            rtol=1e-6, atol=1e-9)
        R.assert_close_tree(ts.v, jax.tree.map(np.asarray, js.v),
                            rtol=1e-5, atol=1e-12)
        # a bf16 param may land one ulp away (2^-8 relative)
        R.assert_close_tree(tp, jax.tree.map(np.asarray, jp),
                            rtol=2 ** -8 if mixed else 1e-6, atol=1e-9)


def test_adamw_decoupled_decay():
    """Weight decay applies to matrices, not vectors/norms."""
    oc = TOPT.AdamWConfig(lr_peak=1e-2, warmup_steps=0, total_steps=10,
                          weight_decay=0.5)
    params = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
    grads = {"w": torch.zeros((4, 4)), "b": torch.zeros((4,))}
    p2, _ = TOPT.adamw_update(grads, TOPT.adamw_init(params), params, oc, 5)
    assert float(p2["w"][0, 0]) < 1.0
    assert float(p2["b"][0]) == 1.0


# --- microbatching --------------------------------------------------------

MB = 4
ARCH = "qwen3-4b"


def _mb_check(got, want, ref, dtype):
    """(loss, grad_norm, params, m, v) of two steps from the state of
    ``ref`` (tests/_train_reference.py's rules)."""
    loss, gnorm, params, m, v = got
    wloss, wgnorm, wparams, wm, wv = want
    if dtype == "f32":
        np.testing.assert_allclose(float(loss), float(wloss), **R.F32)
        np.testing.assert_allclose(float(gnorm), float(wgnorm), **R.F32)
        R.assert_close_tree(m, wm, **R.F32)
        R.assert_close_tree(v, wv, **R.F32)
        # m = (1 - b1) * clipped grad: its sign is the step's
        R.assert_params_after_first_step(params, wparams, wm, dict(
            rtol=R.F32["rtol"], atol=R.F32["atol"] * 0.1))
    else:
        assert abs(float(loss) - float(wloss)) < R.BF16_ATOL
        np.testing.assert_allclose(float(gnorm), float(wgnorm),
                                   rtol=R.BF16_GNORM_RTOL)
        R.assert_rel_tree(m, wm, R.BF16_REL, "m")
        R.assert_rel_tree(v, wv, R.BF16_REL, "v")
        R.assert_bf16_update(params, ref["params"], wparams, m, wm)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_microbatch_matches_unsplit_step(dtype):
    cfg = TC.get(ARCH, reduced=True)
    ref = R.reference(ARCH, dtype)
    one = R.port_mb(cfg, ref, dtype, None)
    four = R.port_mb(cfg, ref, dtype, MB)
    _mb_check(four, one, ref, dtype)


@pytest.mark.parametrize("dtype,accum_bf16", [("f32", False),
                                              ("bf16", False),
                                              ("bf16", True)])
def test_microbatch_matches_reference(dtype, accum_bf16):
    tcfg = dataclasses.replace(TC.get(ARCH, reduced=True),
                               accum_bf16=accum_bf16)
    want = R.reference_mb(ARCH, dtype, MB, accum_bf16)
    got = R.port_mb(tcfg, R.reference(ARCH, dtype), dtype, MB)
    _mb_check(got, want, R.reference(ARCH, dtype), dtype)


# --- remat and the stacked layers -----------------------------------------

def _grad_nodes(root):
    """Every autograd node behind ``root``, by class name."""
    seen, todo, names = set(), [root.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        todo.extend(n for n, _ in node.next_functions)
    return names


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b",
                                  "recurrentgemma-9b", "seamless-m4t-medium"])
def test_remat_gives_the_same_gradients(arch):
    """``cfg.remat`` recomputes each repeat's activations in the backward
    (``torch.utils.checkpoint``) with the same values: loss and gradients
    bit for bit. Each stacked leaf is unbound once a forward, so its
    gradient is stacked once (no per-layer select of the whole stack)."""
    from repro_torch.models import encdec as TED
    from repro_torch.models import layers as TLL
    from repro_torch.models import lm as TLM
    cfg = TC.get(arch, reduced=True)
    spec = (TED.encdec_spec(cfg, cfg.n_enc, cfg.n_dec)
            if cfg.family == "encdec" else TLM.lm_spec(cfg))
    params = TLL.init_params(spec, generator=torch.Generator().manual_seed(0))
    batch = R.torch_batch(R.numpy_batch(cfg, "bf16"), "bf16")
    batch = TLOOP.batch_on(batch, "cpu")
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        out.append(TLOOP.value_and_grad(TLOOP.make_loss(c), params, batch))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(TLL.leaves(g0), TLL.leaves(g1)):
        assert torch.equal(a, b)
    stacks = [k for k in ("stage", "enc", "dec") if k in params]
    live = TLL.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = TLOOP.make_loss(cfg)(live, batch)
    n_stacked = sum(len(TLL.leaves(live[k])) for k in stacks)
    assert _grad_nodes(loss).count("UnbindBackward0") == n_stacked


# --- the trainer ----------------------------------------------------------

def _setup(jax_side=False):
    cfg = (JC if jax_side else TC).get("qwen3-4b", reduced=True)
    dc = (JD if jax_side else TD).DataConfig(vocab=cfg.vocab,
                                            global_batch=8, seq_len=32)
    oc = (JOPT if jax_side else TOPT).AdamWConfig(
        lr_peak=1e-3, warmup_steps=3, total_steps=30)
    return cfg, dc, oc


def test_loss_decreases():
    cfg, dc, oc = _setup()
    out = TLOOP.Trainer(cfg, dc, oc, TLOOP.TrainConfig(steps=25,
                                                       log_every=4),
                        device="cpu").run()
    assert out["losses"][0][1] > out["losses"][-1][1]
    assert [s for s, _ in out["losses"]] == [0, 4, 8, 12, 16, 20, 24]


def test_crash_resume_reaches_end(tmp_path):
    cfg, dc, oc = _setup()
    tc = TLOOP.TrainConfig(steps=20, ckpt_every=5, ckpt_dir=str(tmp_path),
                           log_every=5)
    with pytest.raises(RuntimeError, match="injected failure at step 12"):
        TLOOP.Trainer(cfg, dc, oc, tc, device="cpu").run(fail_at_step=12)
    # the failure waited for the write in flight: none races the next run
    assert (tmp_path / "step_00000010" / "meta.json").exists()
    assert not [x for x in os.listdir(tmp_path) if x.endswith(".tmp")]
    out = TLOOP.Trainer(cfg, dc, oc, tc, device="cpu").run()  # from step 10
    assert out["final_step"] == 19
    assert [s for s, _ in out["losses"]] == [15, 19]
    kept = sorted(x for x in os.listdir(tmp_path) if x.startswith("step_"))
    assert kept == ["step_00000010", "step_00000015", "step_00000019"]


# A port trainer resuming at step 6 from the reference's checkpoint logs
# the reference's losses for steps 6-9 to within the reference's bf16
# tolerance: the two packages run the same bf16 math, each rounding its
# own way, from the same state on the same batches.
RESUME_ATOL = R.BF16_ATOL


def test_resume_from_a_jax_trainer_checkpoint(tmp_path):
    jcfg, jdc, joc = _setup(jax_side=True)
    tcfg, tdc, toc = _setup()
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    want = JLOOP.Trainer(jcfg, jdc, joc, JLOOP.TrainConfig(
        steps=10, ckpt_every=5, ckpt_dir=str(jax_dir), log_every=1)).run()
    shutil.copytree(jax_dir / "step_00000005", port_dir / "step_00000005")
    got = TLOOP.Trainer(tcfg, tdc, toc, TLOOP.TrainConfig(
        steps=10, ckpt_every=5, ckpt_dir=str(port_dir), log_every=1),
        device="cpu").run()
    want = dict(want["losses"])
    assert [s for s, _ in got["losses"]] == [6, 7, 8, 9]
    for step, loss in got["losses"]:
        assert abs(loss - want[step]) <= RESUME_ATOL, (step, loss,
                                                       want[step])


@pytest.mark.parametrize("arch", ["internvl2-76b", "seamless-m4t-medium"])
def test_trainer_stub_embeddings_equal_the_reference(arch):
    """``_make_batch``'s bf16 patch embeddings / frames: numpy's draws
    cast by torch equal ml_dtypes' cast bit for bit (both round to
    nearest even)."""
    jcfg, tcfg = JC.get(arch, reduced=True), TC.get(arch, reduced=True)
    jt = JLOOP.Trainer(jcfg, JD.DataConfig(vocab=jcfg.vocab, global_batch=4,
                                           seq_len=80),
                       JOPT.AdamWConfig(), JLOOP.TrainConfig())
    tt = TLOOP.Trainer(tcfg, TD.DataConfig(vocab=tcfg.vocab, global_batch=4,
                                           seq_len=80),
                       TOPT.AdamWConfig(), TLOOP.TrainConfig(),
                       device="cpu")
    for step in (0, 3):
        want, got = jt._make_batch(step), tt._make_batch(step)
        assert set(got) == set(want)
        for k in want:
            w = np.asarray(want[k])
            if w.dtype.name == "bfloat16":
                assert got[k].dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    got[k].view(torch.int16).numpy(), w.view(np.int16))
            else:
                np.testing.assert_array_equal(got[k], w)


# --- data -----------------------------------------------------------------

@pytest.mark.parametrize("seed,process_count", [(1234, 1), (7, 4)])
def test_synthetic_tokens_equal_the_reference(seed, process_count):
    kw = dict(vocab=1000, global_batch=8, seq_len=64, seed=seed)
    assert (dataclasses.asdict(TD.DataConfig(**kw))
            == dataclasses.asdict(JD.DataConfig(**kw)))
    for proc in range(process_count):
        t = TD.SyntheticTokens(TD.DataConfig(**kw), process_index=proc,
                               process_count=process_count)
        j = JD.SyntheticTokens(JD.DataConfig(**kw), process_index=proc,
                               process_count=process_count)
        assert t.local_batch == j.local_batch == 8 // process_count
        for step in (0, 5, 17):
            got, want = t.batch(step), j.batch(step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(
        TD.batch_for_step(TD.DataConfig(**kw), 3)["tokens"],
        JD.batch_for_step(JD.DataConfig(**kw), 3)["tokens"])


# --- the launcher ---------------------------------------------------------

def test_launcher_trains_reduced_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-4b", "--reduced", "--device", "cpu", "--steps", "3",
         "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("step     0 loss ")
    assert lines[1].startswith("step     2 loss ")
    assert lines[-1].startswith("done: step 2 ")
    assert (tmp_path / "step_00000002" / "meta.json").exists()
    assert "jax" not in proc.stderr


def test_launcher_refuses_the_mesh_options(capsys):
    # a world of one process: the production meshes' own error, naming
    # the ranks they need
    for flag, ranks in (("--production-mesh", 256), ("--multi-pod", 512)):
        with pytest.raises(SystemExit) as e:
            TLAUNCH.main(["--arch", "qwen3-4b", "--device", "cpu", flag])
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert f"needs {ranks} ranks" in err and "has 1" in err
        assert not torch.distributed.is_initialized()
