"""The port stands alone: no JAX, nothing of the JAX package, and no quiet
fallback to the CPU.

Every ``.py`` under ``src/repro_torch/`` (the training modules of
``train/``, ``data/`` and ``launch/train.py`` among them),
``chip_smoke.py``, ``lm_precision_probe.py`` and the example twins
``examples/torch_*.py`` is parsed with ``ast``;
an import of ``jax``, ``jaxlib`` or ``repro`` (or any of their
submodules) fails the test. ``repro_torch`` itself is allowed. Every
entry point (engines, meshes, LM serving, training, checkpoints)
raises without a card unless the CPU is asked for; so does every example
twin's ``main`` unless ``--device cpu`` (``device="cpu"``) is given.
"""
import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms as TA
from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.core.engine import Engine
from repro_torch.core.engine_shardmap import ShardEngine
from repro_torch.core.mesh import LocalMesh
from repro_torch import configs as LMC
from repro_torch import convert
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers as LML
from repro_torch.models import lm as LMM
from repro_torch.serve import engine as LMS
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import train as LMLAUNCH
from repro_torch.train import checkpoint as LMCKPT
from repro_torch.train import loop as LMLOOP
from repro_torch.train import optimizer as LMOPT

# The tensors here are tiny: one CPU thread keeps torch's thread pool off
# the cores that parallel test workers share.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")
EXAMPLES = ("torch_quickstart", "torch_graph_analytics",
            "torch_query_service", "torch_multi_tenant", "torch_serve_lm",
            "torch_train_lm")
TRAINING = ("train/__init__.py", "train/optimizer.py", "train/loop.py",
            "train/checkpoint.py", "train/compress.py", "data/__init__.py",
            "data/pipeline.py", "launch/train.py")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "lm_precision_probe.py"]
    files += sorted((ROOT / "examples").glob("torch_*.py"))
    return files


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    port = ROOT / "src" / "repro_torch"
    assert {port / f for f in TRAINING} <= set(files)
    bad = []
    for f in files:
        for mod in _imported_modules(ast.parse(f.read_text(), str(f))):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_example_twins_are_scanned():
    assert {ROOT / "examples" / f"{name}.py" for name in EXAMPLES} <= set(
        _port_files())
    for name in EXAMPLES:
        text = (ROOT / "examples" / f"{name}.py").read_text()
        assert 'add_argument("--device"' in text, name


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_twin_defaults_to_the_card(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = _example(name).main
    with pytest.raises(RuntimeError, match="CUDA"):
        if name == "torch_train_lm":
            main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
        else:
            main()


def test_sharding_modules_are_guarded(monkeypatch):
    port = ROOT / "src" / "repro_torch"
    assert {port / "sharding.py", port / "launch" / "mesh.py"} <= set(
        _port_files())
    # the meshes of the card refuse without one
    from repro_torch.launch import mesh as LMESH
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LMESH.make_production_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        LMESH.make_serving_mesh(2)


def test_dryrun_modules_are_guarded():
    """The roofline and the LM dry-run are port files (scanned above);
    importing them starts no process group, and the dry-run's fake world
    is gone on leaving."""
    import torch.distributed as dist
    port = ROOT / "src" / "repro_torch"
    assert {port / "launch" / "roofline.py",
            port / "launch" / "dryrun.py"} <= set(_port_files())
    from repro_torch.launch import dryrun, roofline  # noqa: F401
    from repro_torch.launch.mesh import dryrun_world
    assert not dist.is_initialized()
    with dryrun_world(4):
        assert dist.get_world_size() == 4
        with pytest.raises(RuntimeError, match="already"):
            with dryrun_world(2):
                pass
    assert not dist.is_initialized()


def test_guard_catches_forbidden_imports():
    src = "import jax.numpy as jnp\nfrom repro.core import graph\n" \
          "from repro_torch import Engine\nfrom . import ops\n"
    mods = [m.split(".")[0] for m in _imported_modules(ast.parse(src))]
    assert [m for m in mods if m in FORBIDDEN] == ["jax", "repro"]


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = TG.uniform(40, 3.0, seed=1).symmetrized()
    pg = TPT.partition_graph(g, 2, pad_multiple=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(TA.bfs(), pg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(TA.bfs(), pg, device="cuda")
    res = Engine(TA.bfs(), pg, device="cpu").run()
    assert res.state["parent"][0] == 0 and np.all(res.state["parent"] >= -1)


def test_shard_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = TG.uniform(40, 3.0, seed=1).symmetrized()
    pg = TPT.partition_graph(g, 2, pad_multiple=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardEngine(TA.bfs(), pg, tile_e=16, tile_r=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalMesh(2, "cuda")
    res = ShardEngine(TA.bfs(), pg, mesh=LocalMesh(2, "cpu"), tile_e=16,
                      tile_r=8).run()
    assert res.state["parent"][0] == 0 and np.all(res.state["parent"] >= -1)


def test_lm_serving_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LMC.get("qwen3-4b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        LMS.make_serve_fns(cfg, batch=1, max_len=8)
    p = LML.init_params(LMM.lm_spec(cfg),
                       generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        LMS.greedy_generate(cfg, p, np.ones((1, 4), np.int32), num_new=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_params_from_numpy(cfg, LML.tree_map(
            lambda t: t.float().numpy(), p))
    with pytest.raises(RuntimeError, match="CUDA"):
        LMM.LanguageModel(cfg, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        LMM.LanguageModel(cfg, p)
    # params on another device than the one served on
    prefill, decode, init_cache = LMS.make_serve_fns(cfg, batch=1, max_len=8,
                                                    device="meta")
    with pytest.raises(ValueError, match="params lie on cpu"):
        prefill(p, np.ones((1, 4), np.int32))
    with pytest.raises(ValueError, match="params lie on cpu"):
        decode(p, init_cache(), np.ones((1, 1), np.int32), 4)
    with pytest.raises(ValueError, match="params lie on cpu"):
        LMM.LanguageModel(cfg, p, device="meta")
    with pytest.raises(ValueError, match="the generator lies on cpu"):
        LMM.LanguageModel(cfg, generator=torch.Generator().manual_seed(0),
                          device="meta")


def test_training_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LMC.get("qwen3-4b", reduced=True)
    dc = DataConfig(vocab=cfg.vocab, global_batch=2, seq_len=8)
    args = (cfg, dc, LMOPT.AdamWConfig(), LMLOOP.TrainConfig(steps=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        LMLOOP.Trainer(*args)
    with pytest.raises(RuntimeError, match="CUDA"):
        LMLAUNCH.main(["--arch", "qwen3-4b", "--reduced", "--steps", "1"])
    p = LML.init_params(LMM.lm_spec(cfg),
                       generator=torch.Generator().manual_seed(0))
    tree = {"params": p, "opt": LMOPT.adamw_init(p)}
    LMCKPT.save(str(tmp_path), 0, tree)
    with pytest.raises(RuntimeError, match="CUDA"):
        LMCKPT.restore_latest(str(tmp_path), tree)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.adamw_state_from_numpy(cfg, LMOPT.AdamWState(
            m=LML.tree_map(lambda t: t.float().numpy(), p),
            v=LML.tree_map(lambda t: t.float().numpy(), p), count=0))
    out = LMLOOP.Trainer(*args, device="cpu").run()
    assert out["final_step"] == 0 and out["params"]["embed"].device.type \
        == "cpu"
