"""The port's performance model against ``repro.core.perfmodel``.

Every function the two share must return exactly the reference's values
(the same float arithmetic in the same order) on the paper's platform
for every algorithm profile, several workloads, 1-4 nodes, both modes
and every exchange. The paper checks of tests/test_perfmodel.py run
against the port too, all but the TPU one, whose counterpart is the H100
profile's own checks at the end.
"""
import dataclasses
import math

import pytest

from repro.core import perfmodel as ref
from repro_torch.core import perfmodel as pm

WORKLOADS = [(2 ** 20, 12 * 2 ** 20), (1 << 16, 2 << 16), (1024, 57266),
             (2 ** 21, 32 * 2 ** 21), (10 ** 9, 16 * 10 ** 9)]
NODES = (1, 2, 3, 4)
MODES = ("gravfm", "gravf")
ALGOS = sorted(ref.PAPER_ALGOS)
SHAPES = [{}, {"v_max": 4096, "e_pair_max": 3784, "remote_dst_max": 264,
               "frontier_cap": 1024}]


def _pair(name):
    return ref.PAPER_ALGOS[name], pm.PAPER_ALGOS[name]


def test_shared_names_and_constants():
    """Every name of the reference but its TPU profile, plus the H100
    profile; the paper's platform and algorithm profiles field-equal."""
    shared = set(ref.__all__) - {"TPU_V5E", "tpu_algo"}
    assert shared <= set(pm.__all__)
    assert set(pm.__all__) - shared == {"H100", "H100_ALGOS", "h100_algo",
                                        "ALGO_PROFILES",
                                        "min_nodes_for_memory"}
    assert (dataclasses.asdict(pm.PAPER_PLATFORM)
            == dataclasses.asdict(ref.PAPER_PLATFORM))
    for name in ALGOS:
        a, b = _pair(name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert pm.EXCHANGES == ref.EXCHANGES
    assert pm.PHASE_TERMS == ref.PHASE_TERMS


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ALGOS)
def test_limits_equal_reference(name, mode):
    ra, pa = _pair(name)
    for v, e in WORKLOADS:
        rw, pw = ref.Workload(v, e), pm.Workload(v, e)
        for n in NODES:
            for kw in ({}, {"granularity": True}, {"n_pe": 3},
                       {"granularity": True, "n_pe": 1},
                       {"wire_words": 12345.0}, {"wire_words": 0.0}):
                assert (pm.limits(pm.PAPER_PLATFORM, pa, pw, n_nodes=n,
                                  mode=mode, **kw)
                        == ref.limits(ref.PAPER_PLATFORM, ra, rw, n_nodes=n,
                                      mode=mode, **kw)), (v, e, n, kw)
            for ex in ref.EXCHANGES:
                for shape in SHAPES:
                    got = pm.limits(pm.PAPER_PLATFORM, pa, pw, n_nodes=n,
                                    mode=mode, exchange=ex, **shape)
                    want = ref.limits(ref.PAPER_PLATFORM, ra, rw, n_nodes=n,
                                      mode=mode, exchange=ex, **shape)
                    assert got == want, (v, e, n, ex, shape)
                    assert (pm.phase_projection(got)
                            == ref.phase_projection(want))
                    assert (pm.overlapped_limits(got)
                            == ref.overlapped_limits(want))


@pytest.mark.parametrize("exchange", ref.EXCHANGES)
def test_words_and_traffic_equal_reference(exchange):
    for v, e in WORKLOADS:
        rw, pw = ref.Workload(v, e), pm.Workload(v, e)
        for n in NODES + (8, 256):
            for shape in SHAPES:
                assert (pm.words_per_superstep(exchange, pw, n, **shape)
                        == ref.words_per_superstep(exchange, rw, n,
                                                   **shape))
                assert (pm.traffic_reduction(pw, n, **shape)
                        == ref.traffic_reduction(rw, n, **shape))


@pytest.mark.parametrize("name", ALGOS)
def test_planning_formulas_equal_reference(name):
    """speedup_eq5, min_nodes_for_memory and optimize (§5.2, eq. 5, §5.7)."""
    ra, pa = _pair(name)
    for v, e in WORKLOADS:
        rw, pw = ref.Workload(v, e), pm.Workload(v, e)
        for n in NODES:
            assert pm.speedup_eq5(pa, pw, n) == ref.speedup_eq5(ra, rw, n)
        assert (pm.min_nodes_for_memory(pm.PAPER_PLATFORM, pa, pw)
                == ref.min_nodes_for_memory(ref.PAPER_PLATFORM, ra, rw))
        for mode in MODES:
            if pm.min_nodes_for_memory(pm.PAPER_PLATFORM, pa, pw) > \
                    pm.PAPER_PLATFORM.n_nodes_max:
                # no configuration fits: both raise on the empty search
                for mod, plat, algo, wl in (
                        (pm, pm.PAPER_PLATFORM, pa, pw),
                        (ref, ref.PAPER_PLATFORM, ra, rw)):
                    with pytest.raises(TypeError):
                        mod.optimize(plat, algo, wl, mode=mode)
                continue
            assert (pm.optimize(pm.PAPER_PLATFORM, pa, pw, mode=mode)
                    == ref.optimize(ref.PAPER_PLATFORM, ra, rw, mode=mode))


def test_overlapped_projection_equal_reference():
    for tc, tw in ((0.0, 0.0), (1e-3, 2e-3), (5.0, 0.1), (-1.0, 3.0)):
        assert (pm.overlapped_projection(tc, tw)
                == ref.overlapped_projection(tc, tw))


# ---- the paper checks of tests/test_perfmodel.py, on the port ----------

WL_PEAK = pm.Workload(num_vertices=2 ** 21, num_edges=32 * 2 ** 21)
REPORTED = {"wcc": 5.791e9, "bfs": 5.493e9, "pagerank": 4.623e9}


@pytest.mark.parametrize("algo", ALGOS)
def test_paper_peaks_within_model_limits(algo):
    lim = pm.limits(pm.PAPER_PLATFORM, pm.PAPER_ALGOS[algo], WL_PEAK,
                    n_nodes=4, mode="gravfm")
    frac = REPORTED[algo] / lim["T_sys"]
    assert 0.85 <= frac <= 1.0, (algo, frac)


def test_pe_limit_binds_and_gravf_is_network_bound():
    a = pm.PAPER_ALGOS["wcc"]
    m = pm.limits(pm.PAPER_PLATFORM, a, WL_PEAK, n_nodes=4, mode="gravfm")
    g = pm.limits(pm.PAPER_PLATFORM, a, WL_PEAK, n_nodes=4, mode="gravf")
    assert m["bottleneck"] == "L_PE"
    assert g["bottleneck"] in ("L_if", "L_net")
    assert m["T_sys"] > g["T_sys"]


def test_eq5_speedup_is_the_limit_ratio():
    assert abs(pm.speedup_eq5(pm.PAPER_ALGOS["wcc"], WL_PEAK, 4) - 8) < 1e-9
    wl = pm.Workload(2 ** 20, 6 * 2 ** 20)
    a = pm.PAPER_ALGOS["bfs"]
    for n in (2, 3, 4):
        m = pm.limits(pm.PAPER_PLATFORM, a, wl, n_nodes=n, mode="gravfm")
        g = pm.limits(pm.PAPER_PLATFORM, a, wl, n_nodes=n, mode="gravf")
        assert math.isclose(m["L_if"] / g["L_if"], pm.speedup_eq5(a, wl, n),
                            rel_tol=1e-9)


def test_degree_dependence_and_granularity():
    a = pm.PAPER_ALGOS["wcc"]
    lims = [pm.limits(pm.PAPER_PLATFORM, a,
                      pm.Workload(2 ** 20, d * 2 ** 20), n_nodes=4)["L_if"]
            for d in (2, 8, 32)]
    assert lims[0] < lims[1] < lims[2]
    assert math.isclose(lims[2] / lims[0], 16.0, rel_tol=1e-9)
    wl = pm.Workload(2 ** 20, 2 * 2 ** 20)
    base = pm.limits(pm.PAPER_PLATFORM, a, wl, n_nodes=4)["L_mem"]
    refined = pm.limits(pm.PAPER_PLATFORM, a, wl, n_nodes=4, n_pe=9,
                        granularity=True)["L_mem"]
    assert refined < base
    floor = 4 * pm.PAPER_PLATFORM.bw_mem / pm.PAPER_PLATFORM.m_memword
    assert refined >= floor * 0.99


def test_optimizer_picks_paper_configuration():
    out = pm.optimize(pm.PAPER_PLATFORM, pm.PAPER_ALGOS["wcc"], WL_PEAK)
    assert (out["n_nodes"], out["n_pe"]) == (4, 9)
    wl = pm.Workload(2 ** 22, 2 * 2 ** 22)
    out = pm.optimize(pm.PAPER_PLATFORM, pm.PAPER_ALGOS["wcc"], wl,
                      mode="gravf")
    if out["bottleneck"] in ("L_if", "L_net"):
        assert out["n_pe"] < pm.PAPER_PLATFORM.n_pe_max
    big = pm.Workload(10 ** 9, 16 * 10 ** 9)
    assert pm.min_nodes_for_memory(pm.PAPER_PLATFORM,
                                   pm.PAPER_ALGOS["wcc"], big) > 1


def test_exchange_traffic_model():
    a = pm.PAPER_ALGOS["bfs"]
    for n in (2, 4, 8):
        wl = pm.Workload(2 ** 20, 12 * 2 ** 20)
        base = pm.limits(pm.PAPER_PLATFORM, a, wl, n_nodes=n)
        wlim = pm.limits(pm.PAPER_PLATFORM, a, wl, n_nodes=n,
                         exchange="allgather")
        assert math.isclose(base["L_if"], wlim["L_if"], rel_tol=1e-9)
        assert math.isclose(base["L_net"], wlim["L_net"], rel_tol=1e-9)
    for deg in (1, 2, 4, 8, 32, 128):
        for p in (2, 4, 8):
            wl = pm.Workload(1 << 16, deg << 16)
            assert (pm.words_per_superstep("combined", wl, p)["total"]
                    <= pm.words_per_superstep("unicast", wl, p)["total"]
                    + 1e-9)
    reds = [pm.traffic_reduction(pm.Workload(1 << 16, d << 16), 4)
            for d in (2, 4, 8, 16, 32, 64, 128)]
    assert all(b >= a - 1e-9 for a, b in zip(reds, reds[1:])), reds
    assert reds[-1] > 10.0
    comb = pm.limits(pm.PAPER_PLATFORM, pm.PAPER_ALGOS["wcc"], WL_PEAK,
                     n_nodes=4, exchange="combined")
    uni = pm.limits(pm.PAPER_PLATFORM, pm.PAPER_ALGOS["wcc"], WL_PEAK,
                    n_nodes=4, exchange="unicast")
    red = pm.traffic_reduction(WL_PEAK, 4)
    assert math.isclose(comb["L_if"] / uni["L_if"], red, rel_tol=1e-9)
    assert math.isclose(red, 4.0, rel_tol=1e-3)
    with pytest.raises(ValueError):
        pm.words_per_superstep("bogus", WL_PEAK, 4)


# ---- the H100 profile (the counterpart of the TPU check) ---------------

RMAT20 = pm.Workload(1_048_576, 31_404_266)


def test_h100_is_one_card_without_a_wire():
    assert pm.H100.name == "NVIDIA H100 80GB HBM3"
    assert pm.H100.n_nodes_max == 1
    assert math.isinf(pm.H100.bw_if) and math.isinf(pm.H100.bw_network)
    assert set(pm.H100_ALGOS) == set(pm.PAPER_ALGOS)
    assert pm.ALGO_PROFILES[pm.H100] is pm.H100_ALGOS
    assert pm.ALGO_PROFILES[pm.PAPER_PLATFORM] is pm.PAPER_ALGOS
    for name, algo in pm.H100_ALGOS.items():
        for ex in (None,) + pm.EXCHANGES:
            lim = pm.limits(pm.H100, algo, RMAT20, n_nodes=1, exchange=ex)
            assert lim["L_if"] == lim["L_net"] == math.inf
            assert lim["T_sys"] == min(lim["L_PE"], lim["L_mem"]) > 0
        # the mesh a dry-run projects: the wire stays unbounded
        lim = pm.limits(pm.H100, algo, RMAT20, n_nodes=256,
                        exchange="allgather")
        assert lim["L_if"] == lim["L_net"] == math.inf


def test_h100_cpe_fit_is_the_busy_teps():
    """L_PE of a fitted profile is the edges over the busy seconds it was
    fitted from, whatever clock f_clk names."""
    algo = pm.h100_algo("x", busy_s=0.0125, edges=31_404_266, m_vertex=5)
    lim = pm.limits(pm.H100, algo, RMAT20, n_nodes=1)
    assert math.isclose(lim["L_PE"], 31_404_266 / 0.0125, rel_tol=1e-12)
    fast = dataclasses.replace(pm.H100, f_clk=2 * pm.H100.f_clk)
    assert math.isclose(
        algo.cpe, pm.H100.n_pe_max * pm.H100.f_clk * 0.0125 / 31_404_266)
    assert pm.limits(fast, algo, RMAT20, n_nodes=1)["L_PE"] == \
        2 * lim["L_PE"]


def test_h100_optimizer_and_memory():
    for name, algo in pm.H100_ALGOS.items():
        out = pm.optimize(pm.H100, algo, RMAT20)
        assert out["n_nodes"] == 1
        assert 1 <= out["n_pe"] <= pm.H100.n_pe_max
        assert pm.min_nodes_for_memory(pm.H100, algo, RMAT20) == 1
    algo = pm.H100_ALGOS["bfs"]
    # ten boards' worth of edges: min_nodes reads m_board
    big = pm.Workload(1 << 20, int(10 * pm.H100.m_board / algo.m_edge))
    need = pm.min_nodes_for_memory(pm.H100, algo, big)
    assert need == math.ceil((big.num_vertices * algo.m_vertex
                              + big.num_edges * algo.m_edge)
                             / pm.H100.m_board) == 11
    half = dataclasses.replace(pm.H100, m_board=pm.H100.m_board * 2)
    assert pm.min_nodes_for_memory(half, algo, big) == 6
