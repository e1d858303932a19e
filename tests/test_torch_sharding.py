"""The port's sharding specs held against the reference's, exactly (CPU).

For every arch of ``configs.ARCH_IDS`` × every ``INPUT_SHAPES`` entry it
supports × the meshes (16, 16), (2, 16, 16), (2, 2) and (4, 1): the
reference's functions on ``jax.sharding.AbstractMesh`` and its
``eval_shape`` structures, the port's on its shape-only mesh and its meta
structures. ``moe_strategy``, ``params_pspecs``, ``batch_pspecs`` (train
and prefill shapes), ``cache_pspecs`` (decode shapes: every cache kind)
and the specs of ``activation_specs`` must be the same spec for spec.
``make_production_mesh`` has the reference's names and sizes
(``src/repro/launch/mesh.py:38-41``), and a :class:`Sharding` cuts and
places blocks as the spec says.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.launch import sharding as jsharding
from repro.launch.steps import params_structs as jparams_structs
from repro.models.cache import AttnCache as JAttnCache
from repro_torch import configs as tconfigs
from repro_torch.launch import sharding as tsharding
from repro_torch.launch.mesh import ShapeMesh, make_production_mesh
from repro_torch.launch.steps import params_structs as tparams_structs
from repro_torch.models.cache import AttnCache
from repro_torch.models.config import INPUT_SHAPES

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x2": (("data", "model"), (2, 2)),
          "4x1": (("data", "model"), (4, 1))}


@functools.lru_cache(maxsize=None)
def _params(arch: str, shape_name: str):
    """Both packages' parameter structures of ``arch`` at a shape (the
    config can depend on it: the long-context window)."""
    jcfg = jconfigs.get_config(arch, shape_name)
    tcfg = tconfigs.get_config(arch, shape_name)
    return jcfg, tcfg, jparams_structs(jcfg), tparams_structs(tcfg)


def _jspec(spec) -> tuple:
    return tuple(spec)


def _same_tree(port, ref) -> None:
    """A port spec tree (nested dicts of tuples) against a reference one
    (nested dicts of PartitionSpecs), key for key."""
    if isinstance(ref, dict):
        assert port.keys() == ref.keys()
        for k in ref:
            _same_tree(port[k], ref[k])
        return
    assert port == _jspec(ref), (port, ref)


def _same_cache(port, ref) -> None:
    """Cache spec NamedTuples, field for field."""
    if isinstance(ref, tuple) and hasattr(ref, "_fields"):
        assert type(port).__name__ == type(ref).__name__
        assert port._fields == ref._fields
        for p, r in zip(port, ref):
            _same_cache(p, r)
        return
    assert port == _jspec(ref), (port, ref)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(tconfigs.ARCH_IDS))
def test_specs_match_the_reference(arch, mesh_name):
    names, sizes = MESHES[mesh_name]
    jmesh, tmesh = AbstractMesh(sizes, names), ShapeMesh(names, sizes)
    assert tuple(jconfigs.ARCH_IDS) == tuple(tconfigs.ARCH_IDS)
    checked = 0
    for shape_name, shape in INPUT_SHAPES.items():
        if not tconfigs.supports_shape(arch, shape):
            assert not jconfigs.supports_shape(arch, shape_name)
            continue
        jcfg, tcfg, jp, tp = _params(arch, shape_name)
        mode = tsharding.moe_strategy(tcfg, shape, tmesh)
        assert mode == jsharding.moe_strategy(jcfg, shape, jmesh)
        _same_tree(tsharding.params_pspecs(tp, tmesh, mode),
                   jsharding.params_pspecs(jp, jmesh, mode))
        jspecs, tspecs = jconfigs.input_specs(jcfg, shape), tconfigs.input_specs(tcfg, shape)
        if shape.kind in ("train", "prefill"):
            _same_tree(tsharding.batch_pspecs(tspecs["batch"], tmesh),
                       jsharding.batch_pspecs(jspecs["batch"], jmesh))
        else:
            _same_cache(tsharding.cache_pspecs(tspecs["cache"], tmesh),
                        jsharding.cache_pspecs(jspecs["cache"], jmesh))
        want = jsharding.activation_specs(jcfg, shape, jmesh)
        got = tsharding.activation_specs(tcfg, shape, tmesh)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].spec == _jspec(want[k].spec), (k, got[k].spec, want[k].spec)
        checked += 1
    assert checked == (4 if tconfigs.supports_shape(arch, "long_500k") else 3)


def test_every_cache_kind_is_covered():
    """The decode shapes above reach each of the four cache kinds."""
    kinds = {type(tconfigs.input_specs(tconfigs.get_config(a, "decode_32k"),
                                       "decode_32k")["cache"]).__name__
             for a in tconfigs.ARCH_IDS}
    assert kinds == {"AttnCache", "SSMCache", "HybridCache", "EncDecCache"}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_has_the_reference_names_and_sizes(multi_pod):
    """``src/repro/launch/mesh.py:38-41``: (16, 16) over ("data", "model"),
    (2, 16, 16) over ("pod", "data", "model")."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    want = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    assert mesh.shape == want and tuple(mesh.axis_names) == tuple(want)
    assert mesh.mesh_dim_names == mesh.axis_names
    assert [mesh.size(i) for i in range(len(want))] == list(want.values())
    assert mesh.devices.size == (512 if multi_pod else 256)
    jmesh = AbstractMesh(tuple(want.values()), tuple(want))
    assert tsharding.axis_sizes(mesh) == dict(jmesh.shape)


def test_a_sharding_cuts_and_places_blocks_as_the_spec_says():
    """Blocks over ("pod", "data") are pod-major, as JAX lays them out;
    every rank's block put back tiles the whole tensor; ``to_shardings``
    keeps a cache's NamedTuple and a replicated leaf is its own block."""
    mesh = ShapeMesh(("pod", "data", "model"), (2, 2, 3))
    sh = tsharding.Sharding(mesh, (("pod", "data"), "model"))
    whole = torch.arange(8 * 6).reshape(8, 6)
    assert sh.block_shape(whole.shape) == (2, 2)
    rebuilt = torch.full_like(whole, -1)
    for p in range(2):
        for d in range(2):
            for m in range(3):
                index = sh.index({"pod": p, "data": d, "model": m}, whole.shape)
                assert index[0].start == (p * 2 + d) * 2 and index[1].start == m * 2
                rebuilt[index] = whole[index]
    assert torch.equal(rebuilt, whole)
    with pytest.raises(ValueError, match="does not split"):
        sh.block_shape((6, 6))
    cache = JAttnCache(k=jax.ShapeDtypeStruct((2, 4, 8, 2, 4), jnp.float32),
                       v=jax.ShapeDtypeStruct((2, 4, 8, 2, 4), jnp.float32),
                       pos=jax.ShapeDtypeStruct((8,), jnp.int32))
    meta = torch.device("meta")
    tcache = AttnCache(k=torch.empty((2, 4, 8, 2, 4), device=meta),
                       v=torch.empty((2, 4, 8, 2, 4), device=meta),
                       pos=torch.empty((8,), dtype=torch.int64, device=meta))
    specs = tsharding.cache_pspecs(tcache, mesh)
    shardings = tsharding.to_shardings(specs, mesh)
    assert type(shardings).__name__ == "AttnCache"
    assert shardings.k.spec == specs.k and shardings.pos.replicated()
    assert tsharding.Sharding(mesh, (None, None)).block(whole) is whole
    _same_cache(specs, jsharding.cache_pspecs(cache, AbstractMesh((2, 2, 3), (
        "pod", "data", "model"))))
    assert specs.k == (None, ("pod", "data"), None, None, None)
