"""The training loss's variants held against the live reference on the CPU.

``loss_weights`` and ``reduce=False`` (the PO-FL trainer's reweighting and
its statistics passes), ``chunked_ce`` over several chunks with its pad
masked, and ``remat``: the port's gradients with ``remat=True`` equal its
own without, bitwise, and match the reference's ``remat=True``. The cases
and the tolerance are ``tests/test_torch_train_loss.py``'s.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from _torch_parity import (
    TRAIN_ARCHS, assert_close, assert_grads_close, jax_batch, port_value_and_grad, t,
    torch_batch, train_case,
)

from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.models import transformer as jtransformer
from repro_torch.convert import lm_params_from_jax
from repro_torch.flatten_util import tree_map
from repro_torch.models import api as tapi
from repro_torch.models import encdec as tencdec
from repro_torch.models import transformer as ttransformer


def _weights(b, seed=5):
    return np.random.default_rng(seed).uniform(0.0, 2.0, b).astype(np.float32)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_weighted_and_per_example_losses_match_reference(arch):
    """``loss_weights`` in the reduced loss and its gradient, and the
    weighted per-example vector of ``reduce=False`` with its aux."""
    jcfg, tcfg, jp, batch = train_case(arch, b=4, seed=1)
    jp = jax.tree.map(jnp.asarray, jp)
    w = _weights(4)
    jb, tb = jax_batch(batch), torch_batch(batch)
    (want, _), want_g = jax.value_and_grad(
        lambda p: japi.model_loss(p, jcfg, jb, loss_weights=jnp.asarray(w)), has_aux=True)(jp)
    tp = lm_params_from_jax(jp, tcfg, device="cpu")
    got, got_g = port_value_and_grad(
        lambda p: tapi.model_loss(p, tcfg, tb, loss_weights=t(w))[0], tp)
    assert_close(got, want)
    assert_grads_close(got_g, want_g)
    want_pe, want_aux = japi.model_loss(jp, jcfg, jb, loss_weights=jnp.asarray(w), reduce=False)
    got_pe, got_aux = tapi.model_loss(tp, tcfg, tb, loss_weights=t(w), reduce=False)
    assert got_pe.shape == (4,)
    assert_close(got_pe, want_pe)
    assert_close(got_aux, want_aux)


def test_chunked_ce_over_two_chunks_with_the_pad_masked():
    """S = 1,090: 1,089 predicting positions in two chunks of 1,024, 959 of
    them pad; the per-example NLL and its gradient in the hidden state and
    the head, from a given hidden state (no RoPE runs)."""
    jcfg, tcfg, jp, _ = train_case("qwen2-0.5b", layers=1)
    rng = np.random.default_rng(3)
    b, s = 2, 1090
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, jp)
    head = {k: jp[k] for k in ("embed", "lm_head") if k in jp}

    def jloss(hp, xx):
        return jnp.sum(jtransformer.chunked_ce(hp, jcfg, xx, jnp.asarray(tokens), jnp.float32)
                       * jnp.asarray([1.0, 0.5]))

    want_pe = jtransformer.chunked_ce(head, jcfg, jnp.asarray(x), jnp.asarray(tokens),
                                      jnp.float32)
    want_g = jax.grad(jloss, argnums=(0, 1))(head, jnp.asarray(x))
    thead = lm_params_from_jax({**jax.tree.map(np.asarray, jp)}, tcfg, device="cpu")
    thead = {k: thead[k] for k in head}
    tx = t(x).requires_grad_()
    leaves = [thead[k].requires_grad_() for k in sorted(thead)]
    got_pe = ttransformer.chunked_ce(thead, tcfg, tx, t(tokens, torch.int64), torch.float32)
    assert ttransformer.CE_CHUNK == 1024
    assert_close(got_pe, want_pe)
    got_g = torch.autograd.grad((got_pe * torch.tensor([1.0, 0.5])).sum(), [*leaves, tx])
    assert_grads_close(list(got_g[:-1]), want_g[0])
    assert_close(got_g[-1], want_g[1])
    assert float(got_g[-1][:, -1].abs().max()) == 0.0  # the last position predicts nothing


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-2.7b", "seamless-m4t-large-v2"])
def test_remat_leaves_the_gradients_unchanged_and_matches_reference(arch):
    jcfg, tcfg, jp, batch = train_case(arch, seed=2)
    jp = jax.tree.map(jnp.asarray, jp)
    jb, tb = jax_batch(batch), torch_batch(batch)
    (want, _), want_g = jax.value_and_grad(
        lambda p: japi.model_loss(p, jcfg, jb, remat=True), has_aux=True)(jp)
    tp = lm_params_from_jax(jp, tcfg, device="cpu")
    got, got_g = port_value_and_grad(lambda p: tapi.model_loss(p, tcfg, tb, remat=True)[0], tp)
    plain, plain_g = port_value_and_grad(lambda p: tapi.model_loss(p, tcfg, tb)[0], tp)
    assert torch.equal(got, plain)
    assert all(torch.equal(a, b) for a, b in zip(got_g, plain_g))
    assert_close(got, want)
    assert_grads_close(got_g, want_g)


def test_remat_recomputes_each_layer_in_the_backward_only(monkeypatch):
    """Under ``torch.autograd`` a ``remat=True`` loss runs every layer twice
    (its forward, then the checkpoint's recompute); without a backward
    (``torch.func.jvp``, or no parameter requiring grad) once."""
    _, tcfg, jp, batch = train_case("qwen2-0.5b", seed=2)
    tp, tb = lm_params_from_jax(jp, tcfg, device="cpu"), torch_batch(batch)
    calls = []
    layer_fwd = ttransformer._layer_fwd
    monkeypatch.setattr(ttransformer, "_layer_fwd",
                        lambda *a: calls.append(a[2]) or layer_fwd(*a))
    port_value_and_grad(lambda p: tapi.model_loss(p, tcfg, tb, remat=True)[0], tp)
    assert calls == [0, 1, 1, 0]  # the backward recomputes the last layer first
    calls.clear()
    torch.func.jvp(lambda p: tapi.model_loss(p, tcfg, tb, remat=True)[0], (tp,),
                   (tree_map(torch.ones_like, tp),))
    assert calls == [0, 1]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-76b", "seamless-m4t-large-v2"])
def test_forward_takes_remat_and_keeps_its_values(arch):
    """``forward`` / ``forward_encdec`` with ``remat`` against the
    reference's, and the same logits without it."""
    jcfg, tcfg, jp, batch = train_case(arch, seed=4)
    tp = lm_params_from_jax(jp, tcfg, device="cpu")
    tb = torch_batch(batch)
    jp = jax.tree.map(jnp.asarray, jp)
    if tcfg.arch_type == "encdec":
        want = jencdec.forward_encdec(jp, jcfg, jnp.asarray(batch["tokens"]),
                                      jnp.asarray(batch["frames"]), remat=True)
        got = tencdec.forward_encdec(tp, tcfg, tb["tokens"], tb["frames"], remat=True)
        plain = tencdec.forward_encdec(tp, tcfg, tb["tokens"], tb["frames"])
    else:
        want, _ = jtransformer.forward(jp, jcfg, jnp.asarray(batch["tokens"]),
                                       jax_batch(batch).get("embeds"), remat=True)
        got, _ = ttransformer.forward(tp, tcfg, tb["tokens"], tb.get("embeds"), remat=True)
        plain, _ = ttransformer.forward(tp, tcfg, tb["tokens"], tb.get("embeds"))
    assert torch.equal(got, plain)
    assert_close(got, want)
