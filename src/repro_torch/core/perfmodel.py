"""The paper's §5 analytical performance model.

T_sys = min(L_PE, L_mem, L_if, L_net)            (eq. 9)

with
  L_PE  = n_nodes * n_pe * f_clk / CPE           (eq. 1)
  L_mem = n_nodes * BW_mem / m_edge              (eq. 2, + §5.4 access-
          granularity refinement)
  L_if  = BW_if/(2 m_update) * n/(n-1) * |E|/|V| (eq. 3, GraVF-M)
        = BW_if/(2 m_message) * n^2/(n-1)        (eq. 4, GraVF)
  L_net = BW_net/((n-1) m_update) * |E|/|V|      (eq. 6, GraVF-M)
        = BW_net * n/((n-1) m_message)           (eq. 7, GraVF)

speedup(GraVF-M / GraVF) = |E|/|V| * 1/n * m_update/m_message   (eq. 5/8)

Two platform profiles ship with the model:
  * ``PAPER_PLATFORM`` — the 4x Micron AC-510 (KU060 + HMC, PCIe backplane)
    system of §6.1, with the experimentally measured constants (Table 2).
    Used to validate the model against the paper's own published numbers,
    and the service's default roofline platform, as in the JAX service.
  * ``H100`` — one NVIDIA H100 80GB HBM3, every constant measured on the
    card by ``chip_smoke.py``'s ``platform`` phase (stream rate, random
    gather granularity, SMs, clock, memory), with ``H100_ALGOS``' cycles
    per edge fitted from the device-busy time of the port's engine on the
    card (:func:`h100_algo`). One card has no wire: its interface and
    network rates are unbounded, and ``limits`` at ``n_nodes=1`` sets
    L_if = L_net = inf.

The port's own copy of the formulas of ``repro.core.perfmodel``; the JAX
package's TPU profile (``TPU_V5E``, ``tpu_algo``) is replaced by the H100
one. ``ALGO_PROFILES`` maps each shipped platform to its algorithm
profiles.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

__all__ = [
    "Platform", "AlgoProfile", "Workload", "limits", "speedup_eq5",
    "optimize", "min_nodes_for_memory", "PAPER_PLATFORM", "H100",
    "PAPER_ALGOS", "H100_ALGOS", "h100_algo", "ALGO_PROFILES",
    "words_per_superstep", "traffic_reduction", "EXCHANGES",
    "PHASE_TERMS", "phase_projection", "overlapped_limits",
    "overlapped_projection",
]

GiB = 1024.0 ** 3


@dataclasses.dataclass(frozen=True)
class Platform:
    name: str
    f_clk: float          # Hz
    n_pe_max: int         # PEs per node the fabric fits
    bw_mem: float         # bytes/s per node (edge storage interface)
    bw_if: float          # bytes/s per node network interface (send+recv)
    bw_network: float     # bytes/s total network
    m_board: float        # bytes memory per node
    m_memword: int        # bytes per memory access word (§5.4 granularity)
    n_nodes_max: int = 4


@dataclasses.dataclass(frozen=True)
class AlgoProfile:
    name: str
    cpe: float            # cycles per edge (paper §5.3, measured §6.1)
    m_vertex: int         # bytes of vertex state
    m_update: int         # bytes per update (incl. id/routing overhead)
    m_message: int        # bytes per message
    m_edge: int           # bytes per stored edge


@dataclasses.dataclass(frozen=True)
class Workload:
    num_vertices: int
    num_edges: int

    @property
    def avg_degree(self) -> float:
        return self.num_edges / max(1, self.num_vertices)


# --- §6.1 evaluation platform: 4x AC-510 (KU060 + 4GB HMC), EX-750 PCIe --
PAPER_PLATFORM = Platform(
    name="4xAC-510 (paper §6.1)",
    f_clk=187.5e6,
    n_pe_max=9,
    bw_mem=21.7 * GiB,          # GUPS-measured peak HMC bandwidth
    bw_if=11.7 * GiB,           # Table 2 (send+recv; 5.85 GiB/s each way)
    bw_network=23.4 * GiB,      # lower bound — never limiting (§6.1)
    m_board=4 * GiB,
    m_memword=16,               # HMC 128-bit access granularity
    n_nodes_max=4,
)

# Paper §6.1: measured CPE per algorithm; §3 layouts give the data sizes
# (updates/messages carry a 32-bit vertex id + payload on the wire).
PAPER_ALGOS = {
    "wcc": AlgoProfile("wcc", cpe=1.05, m_vertex=5, m_update=8, m_message=8,
                       m_edge=8),
    "bfs": AlgoProfile("bfs", cpe=1.10, m_vertex=5, m_update=8, m_message=8,
                       m_edge=8),
    "pagerank": AlgoProfile("pagerank", cpe=1.42, m_vertex=8, m_update=8,
                            m_message=8, m_edge=8),
}


# --- One NVIDIA H100 80GB HBM3 (the port's card) ------------------------
# Every constant was measured in one chip call, calibration call 2 of the
# H100 profile (PERF.md §6, "H100 constants"), by chip_smoke.py's
# ``platform`` phase on "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi's
# name and power limit in that call); the phase re-measures each one on
# every run and fails outside 0.5-2x.
H100 = Platform(
    name="NVIDIA H100 80GB HBM3",
    # clocks.max.sm, 1980 MHz, the boost ceiling nvidia-smi reports;
    # clocks.sm read 1980 MHz while the card streamed. L_PE does not
    # depend on this choice: H100_ALGOS' CPE is fitted at the same clock.
    f_clk=1980e6,
    # multi_processor_count: an SM plays the paper's PE
    n_pe_max=132,
    # the median rate of a streaming read of 4 GiB (torch.sum of float32,
    # CUDA events, 5 rounds of 10), 0.926 of the data sheet's 3.35 TB/s
    bw_mem=3102883959440.72,
    # One card has no wire: the shards of a LocalMesh exchange through
    # device memory, and ProcessGroupMesh on NCCL needs two cards.
    bw_if=math.inf,
    bw_network=math.inf,
    # total_memory
    m_board=85017493504,
    # bw_mem over the random int32 gathers a second of a 4 GiB table
    # (index_select of 2**26 int64 indices: 27.07 G/s), the §5.4 access
    # word measured: 114.6 B, the 8-byte index and 4-byte output of each
    # gather included
    m_memword=114.64539357836078,
    n_nodes_max=1,
)


def h100_algo(name: str, *, busy_s: float, edges: int, m_vertex: int,
              m_update: int = 5, m_message: int = 4,
              m_edge: int = 14) -> AlgoProfile:
    """The counterpart of §6.1's measured CPE on the card: the device's
    busy seconds of one warm ``Engine(mode="gravfm").run`` (the profiler's
    device time, summed over its kernels and copies) over the ``edges`` it
    traversed, in SM cycles: ``CPE = n_pe_max * f_clk * busy_s / edges``.
    So ``L_PE = n_pe_max * f_clk / CPE = edges / busy_s`` whatever clock
    ``f_clk`` names: the TEPS of that run with the device never idle.

    Bytes, at the port's dtypes:
      m_update  = 5: the broadcast per vertex, its payload (int32/float32)
                  and its active bit (bool), both gathered over src_slot;
      m_message = 4: the per-edge message (int32/float32);
      m_edge    = 14: the static layout lanes ``Engine._deliver_gravfm``
                  reads each superstep: src_slot 8 (int64) + lane_valid 1
                  + lane_remote 1 + K1's rel 4. w, src_gid and src_outdeg
                  (4 each) and seg_take (8) are read only by a kernel whose
                  scatter or carry uses them (SSSP), not by BFS, WCC or
                  PageRank, whose scatter forwards the payload.
    """
    cpe = H100.n_pe_max * H100.f_clk * busy_s / edges
    return AlgoProfile(name=name, cpe=cpe, m_vertex=m_vertex,
                       m_update=m_update, m_message=m_message, m_edge=m_edge)


# busy_s/edges: chip_smoke.py's phase 6 (profile), the device-busy
# seconds of one warm run on rmat20 (1,048,576 vertices, 31,404,266
# edges) and the edges it traversed, in the same chip call as ``H100``'s
# constants (NVIDIA H100 80GB HBM3, 700.00 W). m_vertex is the state per
# vertex: parent/label int32 + active bool; PageRank's float32 score.
H100_ALGOS = {
    "wcc": h100_algo("wcc", busy_s=0.011973784000000001,
                     edges=106_357_216, m_vertex=5),
    "bfs": h100_algo("bfs", busy_s=0.00952824199999999,
                     edges=31_403_884, m_vertex=5),
    "pagerank": h100_algo("pagerank", busy_s=0.042678996999999996,
                          edges=942_127_980, m_vertex=4),
}

# The algorithm profiles of each shipped platform (the service projects a
# class against its platform's).
ALGO_PROFILES = {PAPER_PLATFORM: PAPER_ALGOS, H100: H100_ALGOS}


# --- Exchange-schedule traffic model (degree-factor compression) --------
EXCHANGES = ("allgather", "ring", "frontier", "unicast", "combined")


def words_per_superstep(exchange: str, wl: Workload, n_nodes: int, *,
                        v_max: Optional[float] = None,
                        e_pair_max: Optional[float] = None,
                        remote_dst_max: Optional[float] = None,
                        frontier_cap: Optional[float] = None,
                        ) -> Dict[str, float]:
    """Wire words one superstep moves under each exchange schedule.

    Per-shard words (each of the ``P`` shards sends this much):

      allgather/ring:  v_max * (P-1)            — whole vertex window, P-1x
      frontier:        2 * cap * (P-1)          — (id, payload) per slot
      unicast:         e_pair_max * (P-1)       — one payload per cut edge
      combined:        min(2*r, e_pair_max) * (P-1)
                                                — (id, payload) per DISTINCT
                                                  remote destination vertex

    where ``r`` is the per-(shard, peer) distinct-destination count. The
    ``min`` clamps combined at the per-edge cost: when fewer than two
    edges share a destination, shipping per-edge blocks (ids static in the
    layout, as unicast does) is never worse, so a schedule that combines
    at source degrades to that. By default the shape parameters are the
    uniform-partition estimates v_max = ceil(V/P), e_pair_max =
    ceil(E/P^2), and r follows the occupancy (coupon-collector) estimate
    ``v*(1-(1-1/v)^e)`` — e edges thrown at v destination slots. Pass the
    exact padded layout values (``meta.v_max``, ``meta.e_pair_max``,
    ``meta.comb_max``) to reproduce the engine's measured counters
    exactly.
    """
    P = int(n_nodes)
    if P <= 1:
        return {"per_shard": 0.0, "total": 0.0}
    vm = float(v_max) if v_max is not None else float(
        math.ceil(wl.num_vertices / P))
    epm = float(e_pair_max) if e_pair_max is not None else float(
        math.ceil(wl.num_edges / (P * P)))
    if exchange in ("allgather", "ring"):
        per = vm * (P - 1)
    elif exchange == "frontier":
        cap = float(frontier_cap) if frontier_cap is not None else vm
        per = 2.0 * cap * (P - 1)
    elif exchange == "unicast":
        per = epm * (P - 1)
    elif exchange == "combined":
        if remote_dst_max is not None:
            r = float(remote_dst_max)
        else:
            v = max(vm, 1.0)
            r = v * (1.0 - (1.0 - 1.0 / v) ** epm)
        per = min(2.0 * r, epm) * (P - 1)
    else:
        raise ValueError(f"unknown exchange {exchange!r}")
    return {"per_shard": float(per), "total": float(per * P)}


def traffic_reduction(wl: Workload, n_nodes: int, **shape) -> float:
    """Degree-factor traffic reduction: unicast words / combined words.

    Saturates at ~e_pair_max/(2*remote_dst) ~= deg/(2*P) * v/r — the
    paper's combine-at-source claim that traffic drops by the average
    degree once many edges share each remote destination."""
    uni = words_per_superstep("unicast", wl, n_nodes, **shape)["total"]
    comb = words_per_superstep("combined", wl, n_nodes, **shape)["total"]
    if comb <= 0.0:
        return 1.0
    return uni / comb


# ------------------------------------------------------------------------
def limits(platform: Platform, algo: AlgoProfile, wl: Workload, *,
           n_nodes: int, n_pe: Optional[int] = None, mode: str = "gravfm",
           granularity: bool = False, exchange: Optional[str] = None,
           wire_words: Optional[float] = None,
           v_max: Optional[float] = None,
           e_pair_max: Optional[float] = None,
           remote_dst_max: Optional[float] = None,
           frontier_cap: Optional[float] = None) -> Dict[str, float]:
    """All four §5 limits (TEPS) + the binding constraint (eq. 9).

    When ``exchange`` (or a measured ``wire_words`` total per superstep)
    is given, L_if and L_net are derived from the exchange schedule's
    actual wire traffic instead of the closed-form eq. 3/6 (which assume
    the allgather/update-combining schedule): a superstep traverses |E|
    edges while moving ``w`` words per shard, so

        L_if  = BW_if * |E| / (2 * w * m_update)       (send+recv)
        L_net = BW_net * |E| / (P * w * m_update)

    This reproduces eq. 3/6 exactly for ``exchange="allgather"`` with the
    analytic v_max = |V|/P.
    """
    assert mode in ("gravf", "gravfm")
    n_pe = platform.n_pe_max if n_pe is None else n_pe
    deg = wl.avg_degree

    l_pe = n_nodes * n_pe * platform.f_clk / algo.cpe                # eq. 1

    if granularity:                                                   # §5.4
        nv_ne = wl.num_vertices / max(1, wl.num_edges)
        spread = min(1.0, nv_ne * n_pe)
        eff_edge = algo.m_edge + spread * (platform.m_memword - algo.m_edge)
        l_mem = n_nodes * platform.bw_mem / eff_edge
    else:
        l_mem = n_nodes * platform.bw_mem / algo.m_edge              # eq. 2

    if n_nodes <= 1:
        l_if = math.inf
        l_net = math.inf
    elif exchange is not None or wire_words is not None:
        if wire_words is not None:
            w_total = float(wire_words)
        else:
            w_total = words_per_superstep(
                exchange, wl, n_nodes, v_max=v_max, e_pair_max=e_pair_max,
                remote_dst_max=remote_dst_max,
                frontier_cap=frontier_cap)["total"]
        if w_total <= 0.0:
            l_if = math.inf
            l_net = math.inf
        else:
            w_shard = w_total / n_nodes
            l_if = (platform.bw_if * wl.num_edges
                    / (2 * w_shard * algo.m_update))
            l_net = (platform.bw_network * wl.num_edges
                     / (w_total * algo.m_update))
    elif mode == "gravfm":
        l_if = (platform.bw_if / (2 * algo.m_update)
                * n_nodes / (n_nodes - 1) * deg)                      # eq. 3
        l_net = (platform.bw_network / ((n_nodes - 1) * algo.m_update)
                 * deg)                                               # eq. 6
    else:
        l_if = (platform.bw_if / (2 * algo.m_message)
                * n_nodes ** 2 / (n_nodes - 1))                       # eq. 4
        l_net = (platform.bw_network * n_nodes
                 / ((n_nodes - 1) * algo.m_message))                  # eq. 7

    t_sys = min(l_pe, l_mem, l_if, l_net)                             # eq. 9
    bottleneck = min(
        (("L_PE", l_pe), ("L_mem", l_mem), ("L_if", l_if), ("L_net", l_net)),
        key=lambda kv: kv[1])[0]
    return {"L_PE": l_pe, "L_mem": l_mem, "L_if": l_if, "L_net": l_net,
            "T_sys": t_sys, "bottleneck": bottleneck}


# Which §5 limit term a measured superstep phase exercises. The phase
# profiler (core/stepper.py profiled mode) attributes superstep wall
# time into these phases; mapping each onto its model term lets the
# observability layer compare the measured split against ``limits()``
# term by term (§6's roofline methodology, per term instead of per
# T_sys). ``probe`` is pure host/dispatch overhead — no model term.
PHASE_TERMS: Dict[str, Optional[str]] = {
    "scatter": "L_mem",       # receiver-side scatter: memory traffic
    "combine": "L_PE",        # gather-combine fold: PE compute (L_node)
    "apply": "L_PE",          # vertex apply: PE compute (L_node)
    "exchange": "L_if",       # shard collective: interface/network wire
    "exchange_serial": "L_if",  # profiled overlapped steppers' serial-
                                # reference exchange (overlap accounting)
    "probe": None,            # host sync — outside the model
}


def phase_projection(lim: Dict[str, float]) -> Dict[str, Optional[float]]:
    """Per-phase TEPS ceiling from a :func:`limits` dict: the model term
    (eq. 1/2/3/6) each measured phase is bounded by, keyed like the
    profiler's ``last_phases``. ``None`` for phases the model has no
    term for (host overhead)."""
    return {phase: (float(lim[term]) if term is not None else None)
            for phase, term in PHASE_TERMS.items()}


def overlapped_limits(lim: Dict[str, float]) -> Dict[str, float]:
    """Overlapped-pipeline projection from a :func:`limits` dict.

    eq. 9's ``T_sys = min(...)`` implicitly assumes the exchange is off
    the critical path — each resource is the bottleneck only when every
    other runs concurrently. A SYNCHRONOUS schedule (collective as a
    barrier between scatter and apply) does NOT satisfy that: compute
    and wire time add per superstep, so its realistic ceiling is the
    harmonic composition

        T_serial  = 1 / (1/L_compute + 1/L_wire)

    with L_compute = min(L_PE, L_mem) and L_wire = min(L_if, L_net).
    The overlapped (window-pipelined) schedule issues the collective for
    window k+1 while window k's scatter/combine folds, hiding the
    smaller of the two costs per window:

        T_overlap = min(L_compute, L_wire) = T_sys

    — i.e. overlap is exactly what makes eq. 9 attainable. Returns
    ``{"T_serial", "T_overlap", "overlap_gain"}`` (gain = projected
    overlapped/serial speedup, >= 1; 1.0 on single-node limits where
    L_wire is infinite)."""
    l_compute = min(lim["L_PE"], lim["L_mem"])
    l_wire = min(lim["L_if"], lim["L_net"])
    if not math.isfinite(l_wire):
        return {"T_serial": l_compute, "T_overlap": l_compute,
                "overlap_gain": 1.0}
    t_serial = 1.0 / (1.0 / l_compute + 1.0 / l_wire)
    t_overlap = min(l_compute, l_wire)
    return {"T_serial": t_serial, "T_overlap": t_overlap,
            "overlap_gain": t_overlap / t_serial}


def overlapped_projection(t_compute: float,
                          t_wire: float) -> Dict[str, float]:
    """Time-domain counterpart of :func:`overlapped_limits`, for
    calibrating against PROFILED phase walls instead of model limits:
    given one superstep's measured local-compute seconds (scatter +
    combine + apply) and exchange seconds under the synchronous
    schedule, project

        serial_s     = t_compute + t_wire     (what synchronous pays)
        overlapped_s = max(t_compute, t_wire) (the pipelined floor)

    and the projected ``gain`` = serial_s/overlapped_s. The mesh
    benchmark divides its measured overlapped superstep wall by
    ``overlapped_s`` for the measured/projected roofline-efficiency
    gate (the §6 methodology applied to the overlap claim)."""
    t_compute = max(0.0, float(t_compute))
    t_wire = max(0.0, float(t_wire))
    serial = t_compute + t_wire
    over = max(t_compute, t_wire)
    return {"serial_s": serial, "overlapped_s": over,
            "gain": serial / over if over > 0 else 1.0}


def speedup_eq5(algo: AlgoProfile, wl: Workload, n_nodes: int) -> float:
    """eq. 5/8: GraVF-M over GraVF when network-limited. The §4.3 filter
    guarantees >= 1 in practice; the raw model value may be < 1."""
    return (wl.avg_degree / n_nodes) * (algo.m_update / algo.m_message)


def min_nodes_for_memory(platform: Platform, algo: AlgoProfile,
                         wl: Workload) -> int:
    """§5.2: enough boards to host vertex state + edges."""
    bytes_needed = (wl.num_vertices * algo.m_vertex
                    + wl.num_edges * algo.m_edge)
    return max(1, math.ceil(bytes_needed / platform.m_board))


def optimize(platform: Platform, algo: AlgoProfile, wl: Workload, *,
             mode: str = "gravfm") -> Dict[str, float]:
    """§5.7: pick n_nodes maximizing T_sys (L_PE/L_mem rise with n, L_if/
    L_net fall), then shrink n_pe to the throughput-preserving minimum
    (power optimization)."""
    lo = min_nodes_for_memory(platform, algo, wl)
    best = None
    for n in range(lo, platform.n_nodes_max + 1):
        lim = limits(platform, algo, wl, n_nodes=n, mode=mode)
        if best is None or lim["T_sys"] > best[1]["T_sys"]:
            best = (n, lim)
    n_nodes, lim = best
    n_pe_needed = math.ceil(
        lim["T_sys"] * algo.cpe / (n_nodes * platform.f_clk))
    n_pe = min(platform.n_pe_max, max(1, n_pe_needed))
    return {"n_nodes": n_nodes, "n_pe": n_pe, **lim}
