"""The static-analysis suite's lock and taxonomy passes over the port.

The port's service and store are copies of the JAX package's lock-bearing
modules; ``repro.analysis``' lock pass (declared lock hierarchy, lock
order, blocking under a lock, ``# lock:`` bindings) and taxonomy pass
(trace event kinds, metric names and the README's vocabulary) run over
them, and over the whole port with the README, as the CLI runs them over
the JAX package. The retrace pass stays with the JAX package: its rules
name ``jax.jit``, ``static_argnums``, ``lax`` loops and traced
collectives, none of which the port has.
"""
import re
from pathlib import Path

import pytest

from repro.analysis.findings import load_source
from repro.analysis.locks import LockPass
from repro.analysis.taxonomy import TaxonomyPass

ROOT = Path(__file__).resolve().parent.parent
LOCK_FILES = ("service/server.py", "service/continuous.py",
              "service/stats.py", "service/trace.py", "service/metrics.py",
              "service/plans.py", "store/registry.py", "store/tenancy.py")
ANNOTATION = re.compile(r"#\s*lock:\s*([\w-]+)")


def _sources(package):
    return [load_source(ROOT, f"src/{package}/{f}") for f in LOCK_FILES]


def _annotations(src):
    return sorted(m.group(1) for line in src.lines
                  for m in [ANNOTATION.search(line)] if m)


@pytest.fixture(scope="module")
def lock_findings():
    return LockPass().run(_sources("repro_torch"))


@pytest.mark.parametrize("rel", LOCK_FILES)
def test_lock_pass_clean_on_port_file(lock_findings, rel):
    errors = [f for f in lock_findings if f.path.endswith(rel)
              and f.severity == "error"]
    assert not errors, [f.to_json() for f in errors]


@pytest.mark.parametrize("rel", LOCK_FILES)
def test_lock_annotations_match_reference(rel):
    """Every ``# lock:`` binding of the JAX file, domain for domain."""
    port = load_source(ROOT, f"src/repro_torch/{rel}")
    ref = load_source(ROOT, f"src/repro/{rel}")
    assert _annotations(port) == _annotations(ref)


def test_thirteen_lock_annotations_in_all():
    assert sum(len(_annotations(s)) for s in _sources("repro_torch")) == 13
    assert not [f for f in LockPass().run(_sources("repro_torch"))
                if f.severity == "error"]


def test_taxonomy_pass_clean_on_port_tree():
    tree = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    srcs = [load_source(ROOT, p.relative_to(ROOT).as_posix())
            for p in tree]
    readme = (ROOT / "README.md").read_text(encoding="utf-8")
    findings = TaxonomyPass(readme_text=readme).run(srcs)
    assert not [f for f in findings if f.severity == "error"], \
        [f.to_json() for f in findings]
    # the pass found the port's trace vocabulary to hold the tree to
    assert any(s.rel.endswith("service/trace.py") for s in srcs)


def test_lock_pass_catches_an_inverted_order(tmp_path):
    """The pass is live on the port's files: a store-lock holder that
    takes the server lock (an inversion of the declared order) in a copy
    of the port's server is an error."""
    src = (ROOT / "src/repro_torch/service/server.py").read_text()
    bad = src.replace(
        "    def _project_teps(self, ck: str) -> Optional[float]:",
        "    def _inverted(self):\n"
        "        with self.store._lock:\n"
        "            with self._lock:\n"
        "                pass\n\n"
        "    def _project_teps(self, ck: str) -> Optional[float]:", 1)
    assert bad != src
    (tmp_path / "server.py").write_text(bad)
    srcs = [load_source(tmp_path, "server.py")] + [
        s for s in _sources("repro_torch")
        if not s.rel.endswith("service/server.py")]
    errors = [f for f in LockPass().run(srcs) if f.severity == "error"]
    assert [f.rule for f in errors] == ["LCK001"]
