"""The shard engine's graph dry-run on the ``meta`` device.

``abstract_shard_data`` against the JAX package's (shapes; dtypes
widened only for the int64 gather indices), the meta superstep against
one real superstep of a ``ShardEngine`` on the CPU (argument bytes,
created bytes, collectives, wire words), and the full cell at pod scale
(R-MAT scale 26 on 256 and 512 shards), which must run on the CPU in
seconds: meta tensors allocate nothing.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine_shardmap as jsm
from repro_torch.core import algorithms as TA
from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.core.engine_shardmap import (_INDEX_FIELDS, EXCHANGES,
                                              ShardEngine, ShardMeta,
                                              abstract_shard_data)
from repro_torch.core.mesh import LocalMesh
from repro_torch.launch import dryrun

torch.set_num_threads(1)

SMALL = ShardMeta(P=4, v_max=256, e_pair_max=192, n_tiles=3, n_windows=2,
                  tile_e=512, tile_r=256, num_vertices=1000,
                  frontier_capacities=(64, 256), comb_max=56, comb_tiles=2,
                  comb_windows=1)
# A cell must take well under this on the CPU (the ring's 255 or 511
# hops take about a second or two).
CELL_SECONDS = 60.0


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_abstract_shard_data_shapes_match_jax(exchange):
    """Each field the port stands in for has the JAX stand-in's shape;
    dtypes equal but for the gather indices, int64 in the port."""
    want = jsm.abstract_shard_data(
        jsm.ShardMeta(**dataclasses.asdict(SMALL)), None, exchange)
    got = abstract_shard_data(SMALL, exchange)
    present = [k for k in got._fields if getattr(got, k) is not None]
    assert present
    for name in present:
        t, sds = getattr(got, name), getattr(want, name)
        assert t.is_meta
        assert sds is not None, name
        assert tuple(t.shape) == tuple(sds.shape), name
        if name in _INDEX_FIELDS:
            assert (t.dtype, sds.dtype) == (torch.int64, jnp.int32), name
        else:
            assert str(t.dtype).rsplit(".", 1)[-1] == str(sds.dtype), name
    # JAX also stands in for the fields its kernel path and flt_cnt read
    skipped = {k for k in want._fields if getattr(want, k) is not None}
    assert skipped - set(present) <= {"flt_cnt", "wid", "rel",
                                      "window_written", "seg", "comb_wid",
                                      "comb_rel", "comb_written"}


def test_meta_engine_holds_no_data_and_runs_ref():
    mesh = LocalMesh(SMALL.P, device="meta")
    assert mesh.device.type == "meta"
    eng = ShardEngine(TA.wcc(), SMALL, mesh=mesh, backend="ref")
    assert eng.pg is None and eng._data is None
    assert eng.params["num_vertices"] == SMALL.num_vertices
    with pytest.raises(ValueError):
        ShardEngine(TA.wcc(), SMALL, mesh=mesh, backend="kernel")
    with pytest.raises(ValueError):
        ShardEngine(TA.wcc(), SMALL, mesh=LocalMesh(2, "meta"),
                    backend="ref")


@pytest.fixture(scope="module")
def small_graph():
    g = TG.rmat(10, 16, seed=3, weighted=True).symmetrized()
    return g, TPT.partition_graph(g, 4)


@pytest.mark.parametrize("algo", ["wcc", "bfs"])
@pytest.mark.parametrize("exchange", EXCHANGES)
def test_meta_superstep_matches_a_real_one(small_graph, exchange, algo):
    """At R-MAT scale 10 on four CPU shards: the meta cell's argument
    bytes are the real engine's device bytes; its created bytes and
    collectives are one real superstep's, recorded the same way; its
    words are the real engine's wire words after one superstep. The
    frontier's meta cell takes the largest bucket: WCC's first superstep
    has every vertex active and takes it too (the real one also creates
    the 8-byte maximum it reads on the host); BFS's first frontier is the
    root alone, the smallest bucket, below the meta cell's bound."""
    g, pg = small_graph
    real = ShardEngine(TA.ALGORITHMS[algo](), pg,
                       mesh=LocalMesh(4, "cpu"), exchange=exchange,
                       backend="ref")
    meta = real.meta
    cell = dryrun.superstep_cell(meta, exchange, algo)
    assert cell["memory"]["data_bytes"] * meta.P == real.device_nbytes
    live = dryrun.superstep_cell(meta, exchange, algo, data=real._data,
                                 mesh=LocalMesh(4, "cpu"))
    words = real.run(max_supersteps=1).comm["wire_words"]
    assert live["collectives"]["total_wire_bytes"] > 0
    mem, live_mem = cell["memory"], live["memory"]
    assert live_mem["argument_bytes"] == mem["argument_bytes"]
    if exchange == "frontier" and algo == "bfs":
        assert (live["collectives"]["total_wire_bytes"]
                < cell["collectives"]["total_wire_bytes"])
        assert words < cell["words_per_superstep"]["total"]
        return
    assert live["collectives"] == cell["collectives"]
    assert cell["words_per_superstep"]["total"] == words
    host_read = 8 if exchange == "frontier" else 0
    assert (live_mem["temp_bytes"] - mem["temp_bytes"]) * meta.P == \
        host_read


def test_collectives_of_each_exchange():
    """The calls of one superstep: two all-gathers (payload, active bit),
    2(P-1) ring hops, the frontier's three all-gathers and one size
    all-reduce, two all-to-alls (key, mail bit)."""
    P = SMALL.P
    calls = {x: {op: c["calls"] for op, c in
                 dryrun.superstep_cell(SMALL, x)["collectives"].items()
                 if op != "total_wire_bytes"} for x in EXCHANGES}
    assert calls == {"allgather": {"all-gather": 2},
                     "ring": {"collective-permute": 2 * (P - 1)},
                     "frontier": {"all-gather": 3, "all-reduce": 1},
                     "unicast": {"all-to-all": 2},
                     "combined": {"all-to-all": 2}}
    ag = dryrun.superstep_cell(SMALL, "allgather")["collectives"]
    # payload int32 and active bool blocks, each to P - 1 peers
    assert ag["all-gather"]["wire_bytes"] == SMALL.v_max * 5 * (P - 1)


def test_graph_meta_is_the_jax_cells():
    """The analytic layout of the JAX cell, plus the combined lanes it
    leaves empty."""
    for P in (256, 512):
        m = dryrun.graph_meta(P)
        V, E = 1 << 26, 16 << 26
        assert m.v_max == -(-V // P // 256) * 256
        assert m.e_pair_max == -(-E // (P * P) // 32) * 32 * 4
        assert m.n_tiles == -(-(E // P) // 512)
        assert m.frontier_capacities == (m.v_max // 16, m.v_max // 4,
                                         m.v_max)
        assert 0 < m.comb_max <= m.e_pair_max and m.comb_max % 32 == 0


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("exchange", EXCHANGES)
def test_graph_cell_at_pod_scale(tmp_path, exchange, multi_pod):
    t0 = time.perf_counter()
    cell = dryrun.run_graph_cell(exchange, multi_pod, "wcc", str(tmp_path))
    assert time.perf_counter() - t0 < CELL_SECONDS
    P = 512 if multi_pod else 256
    mesh = "multipod_512" if multi_pod else "pod_256"
    path = tmp_path / f"graph__wcc__{exchange}__{mesh}.json"
    assert json.loads(path.read_text())["teps_bound"] == cell["teps_bound"]
    assert cell["status"] == "ok" and cell["meta"]["P"] == P
    assert cell["device"] == "meta"
    mem = cell["memory"]
    assert 0 < mem["data_bytes"] < mem["argument_bytes"]
    assert mem["temp_bytes"] > 0
    assert cell["collectives"]["total_wire_bytes"] > 0
    assert cell["words_per_superstep"]["total"] > 0
    rf = cell["roofline"]
    assert rf["L_if"] == rf["L_net"] == "not bounded"
    assert cell["teps_bound"] == rf["T_sys"] == min(rf["L_PE"], rf["L_mem"])
    assert math.isfinite(cell["teps_bound"]) and cell["teps_bound"] > 0


def test_cli_writes_the_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun --graph`` in a process of its
    own (no card: the meta device)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ,
               PYTHONPATH=os.path.join(os.path.dirname(here), "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--graph",
         "--exchange", "frontier", "--algo", "bfs", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("[ok] gravfm-bfs-frontier rmat26 pod_256")
    cell = json.loads(
        (tmp_path / "graph__bfs__frontier__pod_256.json").read_text())
    # the frontier's buffers at the largest bucket: (slot, payload,
    # valid) = 8 + 4 + 1 bytes a slot, to P - 1 peers
    m = cell["meta"]
    ag = cell["collectives"]["all-gather"]
    assert ag["wire_bytes"] == m["v_max"] * 13 * (m["P"] - 1)
    np.testing.assert_equal(cell["words_per_superstep"]["per_shard"],
                            2 * m["v_max"] * (m["P"] - 1))
