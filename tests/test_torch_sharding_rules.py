"""The port's sharding rules (``repro_torch.sharding``) against the JAX
package's (``repro.sharding``), pure and exact.

For every leaf of all ten full configs (the decoder-only tree, and
seamless-m4t-medium's encoder-decoder tree too), every leaf of their
serving caches (``cache_axes``, ``encdec_cache_axes``) and a set of
shapes that the mesh does not divide, the port's spec tuple must equal
``tuple(PartitionSpec)`` of the reference's rules, on
``jax.sharding.AbstractMesh`` meshes of (16, 16), (2, 16, 16), (2, 2) and
(4, 1): no devices and no process group on either side.
"""
import pytest
from jax.sharding import AbstractMesh

from repro import configs as JC
from repro import sharding as JSH
from repro.models import encdec as JED
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch import configs as TC
from repro_torch import sharding as SH
from repro_torch.models import encdec as TED
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x1": ((4, 1), ("data", "model")),
}
# (batch, max_len, enc_len): one the meshes divide, one they do not
CACHES = [(32, 4096, 1024), (3, 100, 7)]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _jax_specs(mesh, abstract, axes):
    return {p: tuple(s.spec) for p, s in
            _flat(JSH.param_sharding_rules(mesh, abstract, axes))}


def _port_specs(mesh, abstract, axes):
    return dict(_flat(SH.param_sharding_rules(mesh, abstract, axes)))


def _meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), SH.MeshShape(shape, names)


def _specs(arch):
    """(name, JAX spec tree, port spec tree) of the arch's param trees."""
    jcfg, tcfg = JC.get(arch), TC.get(arch)
    out = [("lm", JLM.lm_spec(jcfg), TLM.lm_spec(tcfg))]
    if tcfg.family == "encdec":
        out.append(("encdec",
                    JED.encdec_spec(jcfg, jcfg.n_enc, jcfg.n_dec),
                    TED.encdec_spec(tcfg, tcfg.n_enc, tcfg.n_dec)))
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh_name):
    amesh, shape = _meshes(mesh_name)
    for tree, jspec, tspec in _specs(arch):
        want = _jax_specs(amesh, JL.abstract_params(jspec),
                          JL.axes_tree(jspec))
        got = _port_specs(shape, TL.abstract_params(tspec),
                          TL.axes_tree(tspec))
        assert got == want, tree
        # the jax mesh itself is read the same way (duck-typed)
        assert _port_specs(amesh, TL.abstract_params(tspec),
                           TL.axes_tree(tspec)) == want
        # some leaf is sharded on every mesh but (4, 1)'s model axis
        assert any(s != (None,) * len(s) for s in got.values())


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, mesh_name):
    amesh, shape = _meshes(mesh_name)
    jcfg, tcfg = JC.get(arch), TC.get(arch)
    for batch, max_len, enc_len in CACHES:
        jaxes = JLM.cache_axes(jcfg, batch, max_len)
        taxes = TLM.cache_axes(tcfg, batch, max_len)
        assert dict(_flat(taxes)) == dict(_flat(jaxes))
        want = _jax_specs(amesh, JLM.abstract_cache(jcfg, batch, max_len),
                          jaxes)
        got = _port_specs(shape, TLM.abstract_cache(tcfg, batch, max_len),
                          taxes)
        assert got == want, (batch, max_len)
        if tcfg.family != "encdec":
            continue
        n_dec = tcfg.n_dec
        jaxes = JED.encdec_cache_axes(jcfg, n_dec, batch, max_len, enc_len)
        taxes = TED.encdec_cache_axes(tcfg, n_dec, batch, max_len, enc_len)
        assert taxes == jaxes
        want = _jax_specs(amesh, JED.abstract_encdec_cache(
            jcfg, n_dec, batch, max_len, enc_len), jaxes)
        got = _port_specs(shape, TED.abstract_encdec_cache(
            tcfg, n_dec, batch, max_len, enc_len), taxes)
        assert got == want


# logical axes x shapes, many of which a mesh axis does not divide
LOGICAL = [
    (("batch", None), (6, 7)),
    (("batch", "seq_model", None), (8, 33, 64)),
    (("fsdp", "model"), (2560, 9728)),
    (("fsdp", "model"), (17, 30)),
    (("vocab", None), (256206, 1024)),
    (("vocab", None), (151936, 2560)),
    (("expert", "fsdp", None), (64, 2048, 1408)),
    (("expert", "fsdp", None), (6, 18, 1)),
    (("heads", None), (40, 128)),
    (("heads", None), (3, 128)),
    (("kv_seq_pdm", None), (1024, 8)),
    (("kv_seq_pdm", None), (48, 8)),
    (("kv_seq_model", "heads"), (4096, 8)),
    (("stack", "seq", "unknown"), (36, 512, 512)),
    (("batch",), (1,)),
]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_logical_to_spec_replicates_what_does_not_divide(mesh_name):
    amesh, shape = _meshes(mesh_name)
    replicated = 0
    for logical, dims in LOGICAL:
        want = tuple(JSH.logical_to_spec(amesh, logical, dims))
        got = SH.logical_to_spec(shape, logical, dims)
        assert got == want, (logical, dims)
        replicated += sum(a is not None and g is None
                          for a, g in zip(logical, got))
    assert replicated > 0      # the rule was exercised on this mesh


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_axis_helpers_equal_the_reference(mesh_name):
    amesh, shape = _meshes(mesh_name)
    assert SH.batch_axes(shape) == JSH.batch_axes(amesh)
    assert SH.fsdp_axes(shape) == JSH.fsdp_axes(amesh)
    assert SH.model_axis(shape) == JSH.model_axis(amesh)
    for names in ("data", "model", SH.batch_axes(shape)):
        assert SH.axis_size(shape, names) == JSH.axis_size(amesh, names)
    for s in ("fsdp,model", ".,vocab", "stack,heads,.,fsdp", "."):
        assert SH.parse_axes(s) == JSH.parse_axes(s)
