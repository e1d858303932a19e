"""The port's npz checkpoints (``repro_torch.checkpoint``) on the CPU.

``tests/test_checkpoint.py``'s contract for the port: a round trip, one
path rule with or without ``.npz``, a failed save that keeps the published
checkpoint, the meta sidecar published before the npz commit, and a
truncated npz that fails loudly. Then the two packages' files against each
other, through numpy only: a tree of one structure gives the same npz keys
in both, an npz the reference's ``save`` wrote loads in the port's
``restore`` and the reverse. Last, a lattice's whole carry (params, the
seeds' draw streams with their channel state, FedDyn's h and SCAFFOLD's c)
goes through an npz bitwise and the next round from it is bitwise the
round from the original. Values compare bitwise.
"""
from __future__ import annotations

import json
import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jax_restore
from repro.checkpoint import save as jax_save
from repro.checkpoint import save_pytree as jax_save_pytree
from repro.core.local_update import AlgState as JAlgState
from repro_torch.checkpoint import load_pytree, restore, save, save_pytree
from repro_torch.checkpoint.npz import leaves_with_paths
from repro_torch.core.local_update import ALGORITHM_IDS, AlgState
from repro_torch.core.pofl import POFLConfig
from repro_torch.flatten_util import tree_leaves
from repro_torch.sim.engine import FUSED_ALGORITHM, FUSED_POLICY, SimEngine
from repro_torch.sim.tasks import make_model_task


class Moments(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor


def _params(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(6, 4, generator=gen), "b": torch.randn(4, generator=gen),
            "conv": {"k": torch.randn(3, 3, 1, 2, generator=gen)}}


def _opt_state(params):
    return Moments(mu={k: v * 0.1 for k, v in params.items() if k != "conv"},
                   nu=[p.abs() for p in tree_leaves(params)], count=torch.tensor(3))


def _equal_trees(a, b) -> None:
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert isinstance(y, torch.Tensor) and x.dtype == y.dtype, p
        assert torch.equal(x, y), p


def test_roundtrip(tmp_path):
    params = _params()
    opt = _opt_state(params)
    save(str(tmp_path / "ckpt"), step=7, params=params, opt_state=opt)
    zeros = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor)
                 else {"k": torch.zeros_like(v["k"])}) for k, v in params.items()}
    step, p2, o2 = restore(str(tmp_path / "ckpt"), zeros, _opt_state(zeros))
    assert step == 7 and isinstance(o2, Moments)
    _equal_trees(params, p2)
    _equal_trees(opt, o2)


def test_keys_are_the_references_scheme(tmp_path):
    """'/'-joined dict keys (sorted), NamedTuple field names and sequence
    indices; ``None`` writes nothing: the reference's keys for the
    reference's tree of the same structure."""
    tree = {"state": AlgState(h=torch.ones(2, 3), c=None), "z": [torch.zeros(1), None],
            "a": {"y": torch.ones(1), "x": torch.ones(1)}}
    jtree = {"state": JAlgState(h=jnp.ones((2, 3)), c=None), "z": [jnp.zeros(1), None],
             "a": {"y": jnp.ones(1), "x": jnp.ones(1)}}
    save_pytree(str(tmp_path / "port"), tree)
    jax_save_pytree(str(tmp_path / "ref"), jtree)
    with np.load(tmp_path / "port.npz") as p, np.load(tmp_path / "ref.npz") as r:
        assert p.files == r.files == ["a/x", "a/y", "state/h", "z/0"]


def test_reference_checkpoint_restores_in_the_port_and_back(tmp_path):
    rng = np.random.default_rng(2)
    w, b = rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=3).astype(np.float32)
    h = rng.normal(size=(2, 5)).astype(np.float32)
    jax_save(str(tmp_path / "ref"), step=11, params={"w": jnp.asarray(w), "b": jnp.asarray(b)},
             opt_state=JAlgState(h=jnp.asarray(h), c=None), extra={"note": "x"})
    step, params, opt = restore(str(tmp_path / "ref"),
                                {"w": torch.zeros(5, 3), "b": torch.zeros(3)},
                                AlgState(h=torch.zeros(2, 5), c=None))
    assert step == 11 and opt.c is None
    np.testing.assert_array_equal(params["w"].numpy(), w)
    np.testing.assert_array_equal(params["b"].numpy(), b)
    np.testing.assert_array_equal(opt.h.numpy(), h)

    save(str(tmp_path / "port"), step=12, params=params, opt_state=opt)
    step, jparams, jopt = jax_restore(str(tmp_path / "port"),
                                      {"w": jnp.zeros((5, 3)), "b": jnp.zeros(3)},
                                      JAlgState(h=jnp.zeros((2, 5)), c=None))
    assert step == 12
    np.testing.assert_array_equal(np.asarray(jparams["w"]), w)
    np.testing.assert_array_equal(np.asarray(jopt.h), h)


def test_bf16_leaves_roundtrip_and_cross_with_the_reference(tmp_path):
    """A bfloat16 leaf goes through the port's npz bitwise, and through the
    reference's both ways: both packages store its bits as ``|V2``."""
    w = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 5)).astype(np.float32))
    params = {"w": w.bfloat16(), "b": torch.arange(5.0)}
    save(str(tmp_path / "port"), step=2, params=params)
    _, back, _ = restore(str(tmp_path / "port"),
                         {"w": torch.zeros(4, 5, dtype=torch.bfloat16), "b": torch.zeros(5)})
    _equal_trees(params, back)
    with np.load(tmp_path / "port.npz") as p:
        assert p["params/w"].dtype == np.dtype("V2")

    jax_save(str(tmp_path / "ref"), step=3,
             params={"w": jnp.asarray(w.numpy(), dtype=jnp.bfloat16), "b": jnp.arange(5.0)})
    with np.load(tmp_path / "ref.npz") as r, np.load(tmp_path / "port.npz") as p:
        assert r["params/w"].dtype == p["params/w"].dtype
        assert r["params/w"].tobytes() == p["params/w"].tobytes()
    _, from_ref, _ = restore(str(tmp_path / "ref"),
                             {"w": torch.zeros(4, 5, dtype=torch.bfloat16), "b": torch.zeros(5)})
    _equal_trees(params, from_ref)


def test_load_places_each_leaf_on_the_template_dtype():
    """A tensor leaf takes its template's dtype (and device); a non-tensor
    template leaf comes back as the stored numpy array."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        save_pytree(os.path.join(d, "ck"), {"a": torch.arange(4, dtype=torch.int32),
                                            "b": np.arange(3.0)})
        out = load_pytree(os.path.join(d, "ck"),
                          {"a": torch.zeros(4, dtype=torch.int64), "b": np.zeros(3)})
    assert out["a"].dtype == torch.int64 and out["a"].tolist() == [0, 1, 2, 3]
    assert isinstance(out["b"], np.ndarray) and out["b"].tolist() == [0.0, 1.0, 2.0]


def test_suffix_and_suffixless_paths_are_the_same_checkpoint(tmp_path):
    tree = {"a": torch.arange(3.0)}
    save_pytree(str(tmp_path / "ck.npz"), tree, metadata={"step": 3})
    out = load_pytree(str(tmp_path / "ck"), {"a": torch.zeros(3)})
    assert out["a"].tolist() == [0.0, 1.0, 2.0]
    assert json.load(open(tmp_path / "ck.meta.json"))["step"] == 3
    save_pytree(str(tmp_path / "ck2"), tree)
    assert load_pytree(str(tmp_path / "ck2.npz"), {"a": torch.zeros(3)})["a"].tolist() == \
        [0.0, 1.0, 2.0]


def test_failed_save_keeps_published_checkpoint_intact(tmp_path, monkeypatch):
    path = str(tmp_path / "ck")
    save_pytree(path, {"a": torch.full((4,), 7.0)}, metadata={"gen": 1})
    real_savez = np.savez

    def dying_savez(f, **kw):
        f.write(b"garbage-partial-write")
        raise OSError("disk died mid-save")

    monkeypatch.setattr(np, "savez", dying_savez)
    with pytest.raises(OSError, match="disk died"):
        save_pytree(path, {"a": torch.full((4,), 9.0)}, metadata={"gen": 2})
    monkeypatch.setattr(np, "savez", real_savez)
    assert load_pytree(path, {"a": torch.zeros(4)})["a"].tolist() == [7.0] * 4
    assert json.load(open(tmp_path / "ck.meta.json"))["gen"] == 1
    assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]


def test_meta_published_before_npz_commit(tmp_path, monkeypatch):
    order = []
    real_replace = os.replace

    def recording_replace(src, dst):
        order.append(dst)
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", recording_replace)
    save_pytree(str(tmp_path / "ck"), {"a": torch.zeros(2)}, metadata={"t": 1})
    assert [os.path.basename(p) for p in order] == ["ck.meta.json", "ck.npz"]


def test_truncated_npz_fails_loudly(tmp_path):
    path = str(tmp_path / "ck")
    save_pytree(path, {"a": torch.arange(100.0)})
    npz = tmp_path / "ck.npz"
    npz.write_bytes(npz.read_bytes()[:40])
    with pytest.raises(Exception):
        load_pytree(path, {"a": torch.zeros(100)})


def test_lattice_carry_roundtrip_is_bitwise_and_resumes_the_same_round(tmp_path):
    """A lattice's whole carry after two rounds — params, each seed's draw
    stream (generator state and Gauss-Markov channel state), the full
    AlgState — written and read back into a fresh carry's structure; the
    third round from it is bitwise the third round from the original."""
    task = make_model_task("logreg", n_devices=6, n_train=60, n_test=12, device="cpu")
    cfg = POFLConfig(n_devices=6, n_scheduled=2, policy=FUSED_POLICY,
                     local_algorithm=FUSED_ALGORITHM)
    engine = SimEngine(task.loss_fn, task.data, cfg, scenario="churn",
                       scenario_params={"base": "gauss_markov"}, device="cpu")
    algs = list(ALGORITHM_IDS.values())
    axes = dict(noise_b=[1e-10] * len(algs), alpha_b=[0.1] * len(algs),
                seed_b=[0, 1] * (len(algs) // 2), policy_b=[0] * len(algs), algorithm_b=algs)
    state = engine.lattice_start(task.params0, **axes)
    for r in range(2):
        state, _ = engine.lattice_round(state, r, False)
    save_pytree(str(tmp_path / "carry"), {"state": state})
    back = load_pytree(str(tmp_path / "carry"),
                       {"state": engine.lattice_start(task.params0, **axes)})["state"]
    assert len(back.streams) == 2 and back.streams[0].rng.dtype == torch.uint8
    assert torch.count_nonzero(back.alg.c) > 0
    _equal_trees(state, back)
    (_, want), (_, got) = (engine.lattice_round(s, 2, True) for s in (state, back))
    for a, b in zip(leaves_with_paths(want), leaves_with_paths(got)):
        assert torch.equal(a[1], b[1]), a[0]
