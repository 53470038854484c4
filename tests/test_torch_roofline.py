"""The port's roofline (``repro_torch.launch.roofline``) against the JAX
package's (``repro.launch.roofline``): the formulas equal the reference's
exactly when given the reference's own constants, read from its module;
``ring_wire_bytes`` equals what ``parse_collectives`` reads from an HLO
line of each op and group size; the port's ``__all__`` names only what
it defines (the reference's names ``HW``, which it never defines)."""
import itertools

import pytest

from repro.launch import roofline as JR
from repro_torch.launch import roofline as TR

KINDS = ("train", "prefill", "decode")
OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
       "collective-permute")
GROUPS = (1, 2, 16, 256)


def reference_hw():
    """The reference's constants as the port's ``Hardware``."""
    return TR.Hardware("reference", peak_flops=JR.PEAK_BF16,
                       hbm_bytes_per_s=JR.HBM_BW,
                       link_bytes_per_s=JR.ICI_LINK_BW, hbm_bytes=0.0)


@pytest.mark.parametrize("kind", KINDS)
def test_model_flops_matches_reference(kind):
    for n, tokens in itertools.product((1, 4_022_468_096, 21 * 10**9),
                                       (1, 8 * 512, 256 * 4096)):
        assert TR.model_flops(n, tokens, kind) == JR.model_flops(
            n, tokens, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_analytic_hbm_bytes_matches_reference(kind):
    grid = itertools.product(
        (4_022_468_096, 236 * 10**9), (1, 16), (1, 16), (1, 16),
        (0.0, 3.5e9))
    for n, dp, tp, mb, cache in grid:
        kw = dict(n_params=n, n_params_active=n // 3, tokens=256 * 4096,
                  d_model=2560, n_layers=36, vocab=151936, n_dev=dp * tp,
                  dp=dp, tp=tp, kind=kind, microbatch=mb,
                  cache_bytes_per_dev=cache)
        assert TR.analytic_hbm_bytes(**kw) == JR.analytic_hbm_bytes(**kw)


@pytest.mark.parametrize("kind", KINDS)
def test_roofline_matches_reference_at_its_constants(kind):
    hw = reference_hw()
    grid = itertools.product((0.0, 3.1e14, 8.5e15), (0.0, 2.2e11),
                             (0.0, 5.4e8, 2.7e11), (None, 9.9e9),
                             (1, 256, 512))
    for flops, nbytes, wire, ana, n_dev in grid:
        cost = {"flops": flops, "bytes accessed": nbytes}
        colls = {"total_wire_bytes": wire}
        kw = dict(n_devices=n_dev, tokens=256 * 4096,
                  n_params_active=4_022_468_096, kind=kind,
                  analytic_bytes=ana)
        assert TR.roofline(cost, colls, hw=hw, **kw) == JR.roofline(
            cost, colls, **kw)


def test_roofline_defaults_to_the_card():
    """The default hardware is the H100's data sheet: 989 TFLOP/s, 3.35
    TB/s, 80 GB; ``H100_STREAM`` the same card at ``perfmodel.H100``'s
    measured stream rate; the collective rate one 400 Gb/s NIC."""
    from repro_torch.core import perfmodel
    assert (TR.H100.peak_flops, TR.H100.hbm_bytes_per_s,
            TR.H100.hbm_bytes) == (989e12, 3.35e12, 80e9)
    assert TR.H100.link_bytes_per_s == 400e9 / 8
    assert TR.H100_STREAM.hbm_bytes_per_s == perfmodel.H100.bw_mem
    cost = {"flops": 989e12, "bytes accessed": 0.0}
    rf = TR.roofline(cost, {"total_wire_bytes": 25e9}, n_devices=1,
                     tokens=1, n_params_active=1, kind="prefill",
                     analytic_bytes=3.35e12)
    assert rf["t_compute_s"] == rf["t_memory_s"] == 1.0
    assert rf["t_collective_s"] == 0.5 and rf["bound_by"] == "compute"


@pytest.mark.parametrize("op", OPS)
def test_ring_wire_bytes_matches_parse_collectives(op):
    """One synthetic HLO line of ``op`` over each group size: the bytes
    ``parse_collectives`` counts equal ``ring_wire_bytes`` of the line's
    result bytes."""
    for p, n in itertools.product(GROUPS, (1, 4096, 3 * 1024 * 1024)):
        line = (f"  %{op}.7 = f32[{n}]{{0}} {op}(f32[{n}]{{0}} %p.1), "
                f"replica_groups=[{256 // p},{p}]<=[256]")
        got = JR.parse_collectives(line, 256)
        nbytes = 4 * n
        assert got[op] == TR.ring_wire_bytes(op, nbytes, p), (op, p, n)
        assert got["total_wire_bytes"] == got[op]


def test_ring_wire_bytes_rejects_unknown_ops():
    with pytest.raises(ValueError):
        TR.ring_wire_bytes("broadcast", 1024, 4)


def test_no_tpu_constant_in_the_port():
    """The reference's v5e constants (197 TFLOP/s, 819 GB/s, 16 GB a
    chip) appear nowhere in the port's sources."""
    from pathlib import Path
    port = Path(TR.__file__).resolve().parents[1]
    texts = [f.read_text() for f in port.rglob("*.py")]
    for const in ("197e12", "819e9", "16e9"):
        assert not any(const in t for t in texts), const


def test_all_names_are_defined():
    for name in TR.__all__:
        assert hasattr(TR, name), name
    # the reference's export list names a module attribute it never
    # defines (ROADMAP §3: a fault of the reference, repaired in the port)
    assert "HW" in JR.__all__ and not hasattr(JR, "HW")
