"""The LM cells of the port's dry-run (``repro_torch.launch.dryrun``)
against the JAX package's (``repro.launch.dryrun``):

* ``active_param_count`` equal to the reference's for all ten configs;
* every argument leaf's local block on (16, 16) and (2, 16, 16) (params,
  AdamW moments and count, the batch, the serving cache) equal to the
  shard shape of the reference's ``NamedSharding`` of that argument.
  The reference's module sets ``XLA_FLAGS`` (512 host devices) when
  imported, so it runs in a subprocess of its own, and compiles nothing;
* the cost passes' extrapolation: counts from depths 1 and 2, the xLSTM
  loops cut to 2 and 4 timesteps, and 2 and 3 microbatch chunks equal a
  full pass's at a small size;
* one reduced cell of each step kind through ``run_cell`` on the
  production mesh, and the CLI in a subprocess.

The port's side runs in fake process groups in this process
(``launch.mesh.dryrun_world``), each destroyed on leaving.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch import configs as TC
from repro_torch.configs.common import SHAPES, Shape, shape_applicable
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (dryrun_world, make_local_mesh,
                                     make_production_mesh)
from repro_torch.models import layers as L

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
# the counts a cut loop's padding does not touch
EXACT = ("flops", "wire")

_JAX = r"""
import json, sys
sys.path.insert(0, {src!r})
import repro.launch.dryrun as D          # sets XLA_FLAGS first
import jax
from repro import configs
from repro.configs.common import SHAPES, shape_applicable
from repro.launch.mesh import make_production_mesh

def shard_shapes(tree):
    return [list(x.sharding.shard_shape(x.shape))
            for x in jax.tree.leaves(tree)]

out = {{"active": {{a: D.active_param_count(configs.get(a))
                   for a in configs.ARCH_IDS}}, "shapes": {{}}}}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for arch in configs.ARCH_IDS:
        cfg = configs.get(arch)
        params, _ = D._abstract_params(cfg, mesh)
        out["shapes"][f"{{arch}}/{{mp}}/params"] = shard_shapes(params)
        for name, shape in SHAPES.items():
            if not shape_applicable(cfg, shape)[0]:
                continue
            key = f"{{arch}}/{{mp}}/{{name}}"
            out["shapes"][key + "/batch"] = shard_shapes(
                D._batch_sharded(cfg, mesh, shape))
            if shape.kind == "train":
                _, args = D.build_lowerable(cfg, mesh, shape)
                out["shapes"][key + "/opt"] = shard_shapes(args[1])
            if shape.kind == "decode":
                out["shapes"][key + "/cache"] = shard_shapes(
                    D._cache_sharded(cfg, mesh, shape))
print("JAX-JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """The reference's counts and shard shapes, from its subprocess
    (started at once, read when first needed)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    proc = subprocess.Popen([sys.executable, "-c", _JAX.format(src=SRC)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.split("JAX-JSON", 1)[1])


def test_active_param_count_matches_reference(reference):
    for arch in TC.ARCH_IDS:
        assert D.active_param_count(TC.get(arch)) == \
            reference["active"][arch], arch


def _local_shapes(leaves):
    return [list((t.to_local() if D.SH.is_dtensor(t) else t).shape)
            for t in leaves]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_argument_blocks_match_reference_shard_shapes(reference,
                                                      multi_pod):
    """Each leaf's local block on the production mesh's rank 0 (blocks
    are even: every rank's has this shape) against the reference's
    shard shape, leaf for leaf in the reference's tree order."""
    want = reference["shapes"]
    with dryrun_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        for arch in TC.ARCH_IDS:
            cfg = TC.get(arch)
            params, _ = D._abstract_params(cfg, mesh)
            pre = f"{arch}/{multi_pod}"
            assert _local_shapes(L.leaves(params)) == want[pre + "/params"]
            for name, shape in SHAPES.items():
                if not shape_applicable(cfg, shape)[0]:
                    continue
                key = f"{pre}/{name}"
                batch = D._batch_sharded(cfg, mesh, shape)
                assert _local_shapes(L.leaves(batch)) == \
                    want[key + "/batch"], key
                if shape.kind == "train":
                    _, args = D.build_lowerable(cfg, mesh, shape)
                    opt = args[1]
                    got = _local_shapes(L.leaves(opt.m) + L.leaves(opt.v)
                                        + [opt.count])
                    assert got == want[key + "/opt"], key
                if shape.kind == "decode":
                    cache = D._cache_sharded(cfg, mesh, shape)
                    assert _local_shapes(L.leaves(cache)) == \
                        want[key + "/cache"], key


EXTRAPOLATED = [
    # (arch, kind, seq, microbatch): depth 3 from depths 1 and 2; the
    # train steps' 4 chunks from 2 and 3; xlstm-350m's 24 timesteps from
    # loops cut to 2 and 4
    ("qwen3-4b", "train", 32, 4),
    ("deepseek-v2-236b", "decode", 32, 1),
    ("seamless-m4t-medium", "prefill", 32, 1),
    ("xlstm-350m", "prefill", 24, 1),
    ("xlstm-350m", "train", 12, 4),
]


def _full_pass(cfg, mesh, shape, mb):
    """The full pass the extrapolation stands for: a recurrent config's
    loops padded as the cut passes pad theirs (by nothing)."""
    if D.recurrent(cfg):
        with D.recurrence_steps(shape.seq_len):
            return D.step_costs(cfg, mesh, shape, mb)
    return D.step_costs(cfg, mesh, shape, mb)


@pytest.mark.parametrize("arch,kind,seq,mb", EXTRAPOLATED)
def test_extrapolated_costs_equal_the_full_pass(arch, kind, seq, mb):
    """On a (2, 4) mesh of a fake 8-rank group (xlstm-350m: (1, 8), its
    2 heads replicated), at 3 repeats of the block pattern (xlstm-350m's
    training: 1): every count extrapolated from the cost passes equals
    the full pass's (the live peak within 1 %: an estimate). In
    xlstm-350m's training the backward through the cut loops is not
    exactly affine in the timesteps: its operators, bytes and created
    bytes lie within 1 % (0.1-0.2 % at this size); the matrix products
    and the collectives, which the compute and collective terms read,
    are exact."""
    cfg = D._depth_cfg(TC.get(arch, reduced=True), 3)
    shape = Shape("small", seq, 8, kind)
    mesh_shape = (2, 4)
    if arch == "xlstm-350m":
        mesh_shape = (1, 8)
        if kind == "train":
            cfg = D._depth_cfg(cfg, 1)
    with dryrun_world(8):
        mesh = make_local_mesh(("data", "model"), mesh_shape, device="cpu")
        got = D.extrapolated_costs(cfg, mesh, shape, mb)
        want = _full_pass(cfg, mesh, shape, mb)
        if D.recurrent(cfg):
            plain = D.step_costs(cfg, mesh, shape, mb)
    assert got["flops"] > 0 and want["wire"] > 0
    loose = ("ops", "bytes", "created") if (
        D.recurrent(cfg) and kind == "train") else ()
    for k in set(want) | set(got):
        if k in ("host_s", "peak_live"):
            continue
        rel = 1e-2 if k in loose else 1e-12
        assert got.get(k, 0.0) == pytest.approx(want.get(k, 0.0), rel=rel,
                                                abs=1e-6), k
    assert got["peak_live"] == pytest.approx(want["peak_live"], rel=0.01)
    if D.recurrent(cfg):
        # the padding aside (one copy of each loop's output), the uncut
        # step: the products and the collectives exactly
        for k in EXACT + tuple(k for k in plain if "/" in k):
            assert got[k] == pytest.approx(plain[k], rel=1e-12,
                                           abs=1e-6), k


CELLS = [
    # one reduced cell of each step kind on the production mesh; the
    # attention chunks at the full configs' sizes
    ("qwen3-4b", "train_4k", dict(q_chunk=512, kv_chunk=1024)),
    ("xlstm-350m", "prefill_32k", {}),
    ("recurrentgemma-9b", "decode_32k", {}),
]


@pytest.mark.parametrize("arch,shape,overrides", CELLS)
def test_reduced_cell_runs_end_to_end(arch, shape, overrides, tmp_path):
    with dryrun_world(256):
        cell = D.run_cell(arch, shape, False, str(tmp_path),
                          overrides=overrides, reduced=True)
    assert cell["status"] == "ok", cell
    on_disk = json.loads(
        (tmp_path / f"{arch}__{shape}__pod_16x16.json").read_text())
    assert on_disk["roofline"] == cell["roofline"]
    rf = cell["roofline"]
    ref_keys = RL.roofline({}, {}, n_devices=1, tokens=1,
                           n_params_active=1, kind="train").keys()
    assert set(rf) == set(ref_keys) == set(cell["roofline_stream"])
    assert rf["bound_by"] in ("compute", "memory", "collective")
    assert rf["flops_per_device"] > 0 and rf["bytes_per_device"] > 0
    assert rf["t_memory_s"] * RL.H100.hbm_bytes_per_s == pytest.approx(
        cell["roofline_stream"]["t_memory_s"] * RL.H100_STREAM.hbm_bytes_per_s)
    mem = cell["memory"]
    assert mem["peak_estimate_bytes"] == (mem["argument_bytes"]
                                          + mem["peak_live_bytes"])
    assert mem["temp_bytes"] >= mem["peak_live_bytes"] > 0
    assert cell["fits_hbm"] == (mem["peak_estimate_bytes"]
                                < D.HBM_PER_CARD)
    colls = cell["collectives"]
    assert colls["total_wire_bytes"] == pytest.approx(sum(
        v["wire_bytes"] for k, v in colls.items() if k != "total_wire_bytes"))
    assert rf["wire_bytes_per_device"] == colls["total_wire_bytes"]


def test_long_context_cell_is_skipped_with_its_reason():
    cell = D.run_cell("qwen3-4b", "long_500k", False)
    assert cell["status"] == "skipped" and "quadratic" in cell["reason"]


def _cli(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--out", str(tmp_path)], capture_output=True, text=True,
        timeout=300, env=env)


def test_cli_writes_the_cells(tmp_path):
    proc = _cli(["--arch", "qwen3-4b", "--shape", "decode_32k", "--mesh",
                 "single"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("[ok     ] qwen3-4b")
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert [c["status"] for c in summary] == ["ok"]
    assert (tmp_path / "qwen3-4b__decode_32k__pod_16x16.json").exists()


def test_cli_exits_nonzero_on_a_failed_cell(tmp_path):
    proc = _cli(["--arch", "no-such-arch", "--shape", "decode_32k",
                 "--mesh", "single"], tmp_path)
    assert proc.returncode == 1
    assert "[FAILED ] no-such-arch" in proc.stdout
    assert "failures=1" in proc.stdout
