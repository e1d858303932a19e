"""The port's train step held against the live reference on the CPU.

- One step at n_fl = 4 against the reference's own functions composed as
  its ``train_step`` composes them (``launch/steps.py:145-227``):
  ``jax.value_and_grad`` of ``model_loss`` with the per-example weights
  ``repeat(coeffs · n_fl, b / n_fl)`` and remat, ``+ ν · z`` on every leaf
  (z from the reference's noise key, one key a leaf), then
  ``adamw.update``; for a dense and a MoE model (its aux in the loss). The
  noisy gradients that reach the optimizer are held to the reference's, and
  the port's new params and state to the reference's ``adamw.update`` of
  those same gradients: AdamW's first step is g / (|g| + ε), so an entry
  where g + ν z lands within a few ε of 0 turns a 1e-5 difference of g into
  an O(1) one of its update (one entry in 131,072 at ν = 2e-3).
- With ``n_microbatches = 2``, against the reference's own
  ``build_train_step`` on its 1 × 1 host mesh, with ``sgd``.
- ``build_stats_step`` against the reference's sketch on its probes, and
  the serving steps' shapes.

Every comparison is fp32 within 1e-5 of the reference relative to the
leaf's scale (``_torch_parity``). The reference's meshes are built with
Auto axes (``_torch_parity.auto_mesh``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    assert_close, auto_mesh, jax_leaf_normals, t, torch_batch, train_case,
)

from repro.core.sketch import sketch_device_stats as jax_sketch
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.models.config import InputShape as JInputShape
from repro.optim import optimizers as jopt
from repro_torch.convert import lm_params_from_jax, opt_state_from_jax
from repro_torch.flatten_util import tree_leaves, tree_unflatten
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.config import InputShape
from repro_torch.optim import optimizers as topt

SEQ = 16


def _shapes(b):
    return (JInputShape("small_train", seq_len=SEQ, global_batch=b, kind="train"),
            InputShape("small_train", seq_len=SEQ, global_batch=b, kind="train"))


def _assert_state_close(got_params, got_opt, want_params, want_opt):
    for g, w in zip(tree_leaves(got_params), jax.tree.leaves(want_params)):
        assert_close(g, w)
    want = opt_state_from_jax(want_opt, device="cpu")
    assert int(got_opt.step) == int(want.step)
    for tree_g, tree_w in ((got_opt.mu, want.mu), (got_opt.nu, want.nu)):
        assert (tree_g is None) == (tree_w is None)
        for g, w in zip(tree_leaves(tree_g or {}), tree_leaves(tree_w or {})):
            assert_close(g, w.numpy())


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b"])
def test_train_step_at_four_fl_devices_matches_the_composed_reference(arch):
    n_fl, b = 4, 8
    jcfg, tcfg, jp, batch = train_case(arch, b=b, s=SEQ, seed=3)
    jp = jax.tree.map(jnp.asarray, jp)
    coeffs = np.asarray([0.7, 0.0, 1.3, 0.45], np.float32)  # device 1 unscheduled
    noise_amp = np.float32(2e-3)
    jopt_, topt_ = jopt.adamw(1e-3, weight_decay=0.1), topt.adamw(1e-3, weight_decay=0.1)
    k_noise = jax.random.PRNGKey(17)

    # the reference's train_step, composed from its own functions
    w = jnp.repeat(jnp.asarray(coeffs) * n_fl, b // n_fl, total_repeat_length=b)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: japi.model_loss(p, jcfg, jb, dtype=jnp.float32, remat=True, loss_weights=w),
        has_aux=True)(jp)
    leaves, treedef = jax.tree.flatten(grads)
    keys = jax.random.split(k_noise, len(leaves))
    grads = jax.tree.unflatten(treedef, [
        g + noise_amp * jax.random.normal(k, g.shape, g.dtype) for g, k in zip(leaves, keys)])

    seen = {}

    def update(g, state, params):
        seen["grads"] = g
        return topt_.update(g, state, params)

    tp = lm_params_from_jax(jp, tcfg, device="cpu")
    mesh = make_host_mesh(model=1, n_devices=n_fl, device="cpu")
    bundle = tsteps.build_train_step(tcfg, _shapes(b)[1], mesh,
                                     topt.Optimizer(topt_.init, update), dtype=torch.float32,
                                     n_microbatches=1)
    z = tree_unflatten(tp, jax_leaf_normals(k_noise, tp))
    got_p, got_s, got_loss = bundle.fn(tp, topt_.init(tp), torch_batch(batch), t(coeffs),
                                       torch.tensor(noise_amp), z)
    assert_close(got_loss, loss)
    for g, w in zip(tree_leaves(seen["grads"]), jax.tree.leaves(grads)):
        assert g.dtype == torch.float32
        assert_close(g, w)
    port_grads = jax.tree.unflatten(treedef, [jnp.asarray(g.numpy())
                                              for g in tree_leaves(seen["grads"])])
    want_p, want_s = jopt_.update(port_grads, jopt_.init(jp), jp)
    _assert_state_close(got_p, got_s, want_p, want_s)
    assert all(x.dtype == torch.float32 for x in tree_leaves(got_p))


def test_two_microbatches_match_the_reference_build_train_step():
    b = 4
    jcfg, tcfg, jp, batch = train_case("qwen2-0.5b", b=b, s=SEQ, seed=4)
    jshape, tshape = _shapes(b)
    jp = jax.tree.map(jnp.asarray, jp)
    coeffs, noise_amp, k_noise = np.asarray([1.0], np.float32), np.float32(1e-3), \
        jax.random.PRNGKey(5)
    jo, to = jopt.sgd(0.05), topt.sgd(0.05)
    tp = lm_params_from_jax(jp, tcfg, device="cpu")
    jbundle = jsteps.build_train_step(jcfg, jshape, auto_mesh(), jo, dtype=jnp.float32,
                                      n_microbatches=2)
    want_p, want_s, want_loss = jbundle.fn(jp, jo.init(jp), {  # donates jp
        k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(coeffs),
        jnp.asarray(noise_amp), k_noise)

    bundle = tsteps.build_train_step(tcfg, tshape, make_host_mesh(1, 1, "cpu"), to,
                                     dtype=torch.float32, n_microbatches=2)
    assert bundle.arg_structs["batch"]["tokens"].shape == (b, SEQ)
    assert bundle.arg_structs["params"]["embed"].device.type == "meta"
    got_p, got_s, got_loss = bundle.fn(tp, to.init(tp), torch_batch(batch), t(coeffs),
                                       torch.tensor(noise_amp),
                                       tree_unflatten(tp, jax_leaf_normals(k_noise, tp)))
    assert_close(got_loss, want_loss)
    _assert_state_close(got_p, got_s, want_p, want_s)


def test_stats_step_matches_the_reference_sketch():
    n_fl, b = 4, 8
    jcfg, tcfg, jp, batch = train_case("qwen2-0.5b", layers=1, b=b, s=SEQ, seed=6)
    jp = jax.tree.map(jnp.asarray, jp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(8)

    def per_device_loss(p):
        pe, _ = japi.model_loss(p, jcfg, jb, dtype=jnp.float32, remat=True, reduce=False)
        return pe.reshape(n_fl, b // n_fl).mean(axis=1)

    want = jax_sketch(per_device_loss, jp, key, 2)
    tp = lm_params_from_jax(jp, tcfg, device="cpu")
    bundle = tsteps.build_stats_step(tcfg, _shapes(b)[1], make_host_mesh(1, n_fl, "cpu"),
                                     dtype=torch.float32, n_probes=2)
    probes = [tree_unflatten(tp, jax_leaf_normals(kp, tp)) for kp in jax.random.split(key, 2)]
    got = bundle.fn(tp, torch_batch(batch), probes)
    for g, w in zip(got, (want.mean, want.var, want.norm)):
        assert g.shape == (n_fl,)
        assert_close(g, w)


def test_auto_microbatches_and_the_serving_steps():
    jcfg, tcfg, jp, batch = train_case("qwen2-0.5b", b=8, s=SEQ, seed=7)
    big = InputShape("big", seq_len=4096, global_batch=64, kind="train")
    for n_fl in (1, 8):  # the reference's reads the port's mesh as its own
        mesh = make_host_mesh(1, n_fl, "cpu")
        assert tsteps.auto_microbatches(tcfg, big, mesh, budget_gib=0.01) == \
            jsteps.auto_microbatches(jcfg, JInputShape("big", 4096, 64, "train"),
                                     mesh, budget_gib=0.01)
    tp = lm_params_from_jax(jp, tcfg, device="cpu")
    prefill = tsteps.build_prefill_step(tcfg, InputShape("p", SEQ, 8, "prefill"), None,
                                        dtype=torch.float32)
    logits, cache = prefill.fn(tp, torch_batch(batch))
    want, _ = japi.model_prefill(jax.tree.map(jnp.asarray, jp), jcfg,
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    assert_close(logits, want)
    from repro_torch.models.cache import pad_cache

    serve = tsteps.build_serve_step(tcfg, InputShape("d", 32, 8, "decode"), None,
                                    dtype=torch.float32)
    assert serve.arg_structs["cache"].k.shape == (tcfg.n_layers, 8, 32, tcfg.n_kv_heads,
                                                  tcfg.head_dim)
    tok, _ = serve.fn(tp, logits[:, -1].argmax(-1, keepdim=True), pad_cache(cache, 32), SEQ)
    assert tok.shape == (8, 1)
    bundle = tsteps.build_step(tcfg, InputShape("tr", SEQ, 8, "train"), make_host_mesh(1, 4,
                                                                                       "cpu"))
    assert set(bundle.arg_structs) == {"params", "opt_state", "batch", "coeffs", "noise_amp",
                                       "noise"}

