"""The example twins (``examples/torch_*.py``) on the CPU, held to the
reference examples (``examples/*.py``, run here through ``repro``).

Each twin's ``main(device="cpu")`` runs in this process. Where an example
prints answers, they must equal the reference example's printed answers:

* quickstart: every line (graph, partition balance, components,
  supersteps, traversed edges, network words);
* graph_analytics: every (dataset, algorithm)'s supersteps and traversed
  edges (the host walls differ);
* query_service: root 0's reach and depth, the burst's size and maximum
  depth, the plan cache's hits, misses and builds, and the continuous
  service's served count, result-cache hits and builds (batch counts of
  the async burst depend on the thread's timing, in both packages);
* multi_tenant: each round's served queries of tenants a and b, their
  completed counts, and the published version's fresh query. Tenant-c
  is rate-capped, so its sheds depend on the time between rounds: in
  each package they are held to a replay of its token bucket over the
  clocks its registry read. The store line is held to the port's own
  contract: the
  port's engines hold more device bytes than the JAX engines (int64
  gather indices, the kernel's work list), so under the same budget the
  port keeps two graphs resident where the JAX service keeps three.

serve_lm's tokens come from random weights (the reference draws them
with JAX's PRNG), so they are held to a re-scoring instead: each greedy
token is a near-argmax of the CPU's full forward over the generated
sequence, at the bf16 tolerance of ``tests/_lm_reference.py`` (atol
0.75, rtol 0.1). train_lm runs ``--steps 3`` at a small width into a
``tmp_path`` checkpoint directory: its parameter count equals the
reference's for the same flags, its losses are finite, and a second run
resumes from the checkpoint.
"""
import importlib.util
import math
import re
import time
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(name, capsys):
    """(the reference example's stdout, the twin's stdout, the twin's
    return value)."""
    _example(name).main()
    want = capsys.readouterr().out
    got_ret = _example(f"torch_{name}").main(device="cpu")
    got = capsys.readouterr().out
    return want, got, got_ret


def test_quickstart_twin(capsys):
    want, got, ret = _both("quickstart", capsys)
    assert got == want
    assert ret["gravf"] == ret["gravfm"]
    assert ret["comm"]["unicast_words"] > ret["comm"]["bcast_filtered_words"]


_WALL = re.compile(r" wall=\s*[0-9.]+ms")


def test_graph_analytics_twin(capsys):
    want, got, ret = _both("graph_analytics", capsys)
    assert _WALL.sub("", got) == _WALL.sub("", want)
    assert len(ret) == 12
    lines = [ln for ln in got.splitlines() if "supersteps=" in ln]
    for ((dname, aname), (steps, edges)), line in zip(ret.items(), lines):
        assert line.split()[0] == aname
        assert f"supersteps={steps:4d}" in line
        assert f"edges_traversed={edges:9d}" in line


def _answers_query_service(text):
    lines = text.splitlines()
    stats = dict(re.findall(r"'(\w+)': ([0-9.]+)", lines[2]))
    served, hits, builds = re.match(
        r"continuous: (\d+) served, p50=[0-9.]+ms, result_cache_hits=(\d+), "
        r"re-traces=(\d+)", lines[3]).groups()
    return (lines[0], lines[1],
            {k: stats[k] for k in ("queries_completed", "plan_cache_hits",
                                   "plan_cache_misses", "plan_traces")},
            (served, hits, builds))


def test_query_service_twin(capsys):
    want, got, ret = _both("query_service", capsys)
    assert _answers_query_service(got) == _answers_query_service(want)
    assert ret["root0"] == (4096, 5)
    assert len(ret["burst"]) == 64 and max(ret["burst"]) == 5
    assert len(ret["continuous"]) == 32
    assert ret["continuous_counters"]["result_cache_hits"] == 1


_TENANT = re.compile(r"  (tenant-\w): completed=(\d+) shed=(\d+) p50=")
_ROUND = re.compile(r"round (\d) (tenant-\w): (\d+) served, (\d+) shed")


def _record_admissions(monkeypatch, registry_cls, bucket_cls):
    """Record every rate-capped tenant's admissions (the clock each was
    taken at, and the answer); returns a function that replays them
    through a fresh ``bucket_cls`` per tenant and says whether the
    registry decided as its bucket allows."""
    configured, seen = {}, []
    configure, admit = registry_cls.configure, registry_cls.admit

    def configure_(self, name, *, now=None, **kw):
        now = time.perf_counter() if now is None else now
        if kw.get("rate_qps") is not None:
            configured[name] = (kw["rate_qps"], kw.get("burst"), now)
        return configure(self, name, now=now, **kw)

    def admit_(self, name, now=None):
        now = time.perf_counter() if now is None else now
        ok = admit(self, name, now=now)
        seen.append((name, now, ok))
        return ok

    monkeypatch.setattr(registry_cls, "configure", configure_)
    monkeypatch.setattr(registry_cls, "admit", admit_)

    def replay():
        buckets = {n: bucket_cls(r, b, now=t)
                   for n, (r, b, t) in configured.items()}
        return bool(buckets) and all(
            ok == (buckets[n].try_take(now=now) if n in buckets else True)
            for n, now, ok in seen)
    return replay


def test_multi_tenant_twin(capsys, monkeypatch):
    """Tenants a and b's rounds and every line but the store's equal the
    reference's. Tenant-c is capped at 50 qps with a burst of 5, so how
    many of its 8 queries a round serves depends on the time since its
    last round; in each package its sheds are those its token bucket
    allows, replayed over the clocks its registry read."""
    from repro.store import TenantRegistry as JaxRegistry
    from repro.store import TokenBucket as JaxBucket
    from repro_torch.store import TenantRegistry, TokenBucket
    jax_replay = _record_admissions(monkeypatch, JaxRegistry, JaxBucket)
    port_replay = _record_admissions(monkeypatch, TenantRegistry,
                                     TokenBucket)
    want, got, ret = _both("multi_tenant", capsys)
    assert jax_replay() and port_replay()

    def answers(text):
        rounds = _ROUND.findall(text)
        return ([r for r in rounds if r[1] != "tenant-c"],
                [(r[0], int(r[2]) + int(r[3])) for r in rounds
                 if r[1] == "tenant-c"],
                [t for t in _TENANT.findall(text) if t[0] != "tenant-c"],
                [ln for ln in text.splitlines()
                 if ln.startswith("published ")])

    assert answers(got) == answers(want)
    rounds = _ROUND.findall(got)
    assert len(rounds) == 6
    c_served = sum(int(r[2]) for r in rounds if r[1] == "tenant-c")
    c_shed = sum(int(r[3]) for r in rounds if r[1] == "tenant-c")
    assert c_shed > 0
    assert ret["tenants"]["tenant-c"] == (c_served, c_shed)
    assert len(ret["answers"]) == 16 + 16 + c_served
    store = ret["store"]
    assert store["store_graphs"] == 3
    assert store["store_resident_graphs"] <= 2
    assert store["store_evictions"] >= 1 and store["store_spills"] >= 1
    assert store["store_faults"] >= 1
    assert ret["published"][0] == 2


BF16_ATOL, BF16_RTOL = 0.75, 0.1


def test_serve_lm_twin(capsys):
    from repro_torch import configs
    from repro_torch.models import lm as LM
    mod = _example("torch_serve_lm")
    out = mod.main(device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3
    for line, (arch, (prompts, gen)) in zip(lines, out.items()):
        cfg = configs.get(arch, reduced=True)
        assert line.startswith(f"{arch:12s} generated 12 tokens/request "
                               f"batch=4; sample row: ")
        assert prompts.shape == (4, 16) and gen.shape == (4, 12)
        assert gen.min() >= 0 and gen.max() < cfg.vocab
        seq = torch.from_numpy(np.concatenate([prompts, gen[:, :-1]], 1))
        with torch.inference_mode():
            logits = LM.lm_forward(mod.params_for(cfg), seq, cfg)[:, 15:]
        logits = logits.float()
        picked = logits.gather(-1, torch.from_numpy(gen).long()[..., None])
        top = logits.max(-1).values
        slack = top - picked[..., 0]
        assert bool((slack <= BF16_ATOL + BF16_RTOL * top.abs()).all()), \
            (arch, float(slack.max()))


def test_train_lm_twin(tmp_path, capsys):
    import dataclasses

    from repro import configs as JC
    from repro.models.lm import num_params as jax_num_params
    mod = _example("torch_train_lm")
    flags = ["--d-model", "64", "--layers", "2", "--batch", "2",
             "--seq", "32", "--ckpt-dir", str(tmp_path)]
    out = mod.main(["--steps", "3"] + flags, device="cpu")
    text = capsys.readouterr().out
    cfg = dataclasses.replace(
        JC.get("qwen3-4b", reduced=True), d_model=64, n_heads=8, n_kv=4,
        head_dim=64, d_ff=256, vocab=32768, repeats=2, q_chunk=128,
        kv_chunk=128)
    assert out["n_params"] == jax_num_params(cfg)
    assert text.splitlines()[0] == (
        f"arch={cfg.name} params={jax_num_params(cfg)/1e6:.1f}M")
    assert out["final_step"] == 2
    assert out["losses"] and all(math.isfinite(l) for _, l in out["losses"])
    assert any(p.name.startswith("step_") for p in tmp_path.iterdir())
    # a second run resumes from the checkpoint of the first
    again = mod.main(["--steps", "5"] + flags, device="cpu")
    assert again["final_step"] == 4
    assert all(s >= 3 for s, _ in again["losses"])
