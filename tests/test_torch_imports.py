"""The port stands alone: no JAX, nothing of the JAX package, and no quiet
fallback to the CPU.

Every ``.py`` under ``src/repro_torch/`` and ``chip_smoke.py`` is parsed
with ``ast``; an import of ``jax``, ``jaxlib`` or ``repro`` (or any of
their submodules) fails the test. ``repro_torch`` itself is allowed.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms as TA
from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.core.engine import Engine

# The tensors here are tiny: one CPU thread keeps torch's thread pool off
# the cores that parallel test workers share.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
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
    bad = []
    for f in files:
        for mod in _imported_modules(ast.parse(f.read_text(), str(f))):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


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
