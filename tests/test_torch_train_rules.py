"""The training path's building blocks on the CPU: the kernels' autograd
rules, the optimizers, the JVP sketch and the token corpus.

- The ``autograd.Function`` s of the flash and SSD kernels, built over the
  plain forward (run without a graph, as the kernel gives none): their
  ``backward`` against autograd of the plain version and their ``jvp``
  against ``torch.func.jvp`` of it, for causal, windowed and cross
  attention (also over several backward query chunks) and the SSD scan.
- ``sgd`` (momentum 0 and 0.9) and ``adamw`` (weight decay on), under both
  schedules, three steps on identical gradients against the reference's, to
  1e-6.
- ``sketch_device_stats`` against the reference's on its own probes
  (``jax.random.split(key, n_probes)``, then one key a leaf in sorted-key
  order), ``exact_device_stats`` against the reference's, and the norm
  unbiased in law on the port's own generator (``tests/test_sketch.py``).
- ``make_token_dataset`` in law (ROADMAP ground rule 1).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    assert_close, jax_leaf_normals, port_value_and_grad, torch_batch, train_case,
)

from repro.core.sketch import exact_device_stats as jax_exact_stats
from repro.core.sketch import sketch_device_stats as jax_sketch
from repro.models import api as japi
from repro.optim import optimizers as jopt
from repro_torch.convert import lm_params_from_jax, opt_state_from_jax, params_from_jax
from repro_torch.core import sketch as tsketch
from repro_torch.data import make_token_dataset
from repro_torch.flatten_util import tree_leaves, tree_unflatten
from repro_torch.kernels.attention import autograd as attn_autograd
from repro_torch.kernels.attention.ref import flash_attention_ref
from repro_torch.kernels.ssd.autograd import SSDScan, ssd_function
from repro_torch.kernels.ssd.ref import ssd_chunked_ref
from repro_torch.models import api as tapi
from repro_torch.optim import optimizers as topt

# --------------------------------------------------------------------------
# the kernels' autograd Functions, built over the plain forward
# --------------------------------------------------------------------------


def _no_graph(fn):
    """``fn`` run without recording a graph, as a kernel's result has none."""
    @functools.wraps(fn)
    def forward(*args, **kwargs):
        with torch.no_grad():
            return fn(*args, **kwargs)
    return forward


PlainAttention = attn_autograd.attention_function(
    _no_graph(flash_attention_ref))
PlainSSD = ssd_function(_no_graph(lambda xdt, la, B, C, *, chunk: ssd_chunked_ref(
    xdt, la, B, C, chunk)))

# (b, sq, sk, h, kv, dh, causal, window)
ATTN_RULE_CASES = {
    "causal_gqa": (2, 40, 40, 4, 2, 16, True, None),
    "window_7": (1, 40, 40, 4, 2, 16, True, 7),
    "cross": (2, 24, 40, 4, 4, 16, False, None),
}


def _rule_inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal(s).astype(np.float32)) for s in shapes)


@pytest.mark.parametrize("q_chunk", [1024, 16])
@pytest.mark.parametrize("case", list(ATTN_RULE_CASES))
def test_attention_function_rules_match_the_plain_version(case, q_chunk, monkeypatch):
    monkeypatch.setattr(attn_autograd, "BACKWARD_Q_CHUNK", q_chunk)
    b, sq, sk, h, kv, dh, causal, window = ATTN_RULE_CASES[case]
    q, k, v, dout = _rule_inputs([(b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh),
                                  (b, sq, h, dh)], seed=sq + sk)
    tangents = _rule_inputs([q.shape, k.shape, v.shape], seed=7)
    plain = functools.partial(flash_attention_ref, causal=causal, sliding_window=window)

    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    out = PlainAttention.apply(*ins, causal, window, 0)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ins, dout)
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(plain(*ins), ins, dout)
    for g, w in zip(got, want):
        assert_close(g, w.numpy(), 1e-6)

    got_t = torch.func.jvp(lambda *a: PlainAttention.apply(*a, causal, window, 0), (q, k, v),
                           tangents)[1]
    want_t = torch.func.jvp(plain, (q, k, v), tangents)[1]
    assert_close(got_t, want_t.numpy(), 1e-6)


def test_ssd_function_rules_match_the_plain_version():
    b, s, h, p, n, chunk = 2, 64, 3, 8, 5, 16
    xdt, B, C, dy = _rule_inputs([(b, s, h, p), (b, s, n), (b, s, n), (b, s, h, p)], seed=11)
    la = -torch.tensor(np.random.default_rng(12).uniform(0.0, 0.5, (b, s, h)).astype(np.float32))
    ins0 = (xdt * 0.1, la, B, C)
    tangents = _rule_inputs([x.shape for x in ins0], seed=13)

    ins = [x.clone().requires_grad_() for x in ins0]
    y = PlainSSD.apply(*ins, chunk)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, ins, dy)
    ins = [x.clone().requires_grad_() for x in ins0]
    want = torch.autograd.grad(ssd_chunked_ref(*ins, chunk), ins, dy)
    for g, w in zip(got, want):
        assert_close(g, w.numpy(), 1e-6)
    got_t = torch.func.jvp(lambda *a: PlainSSD.apply(*a, chunk), ins0, tangents)[1]
    want_t = torch.func.jvp(lambda *a: ssd_chunked_ref(*a, chunk), ins0, tangents)[1]
    assert_close(got_t, want_t.numpy(), 1e-6)


def test_kernel_functions_refuse_cpu_tensors():
    """Over the CUDA kernels the Functions launch or raise; on the CPU the
    ops never reach them."""
    q = torch.zeros(1, 8, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        attn_autograd.FlashAttention.apply(q, q, q, True, None, 0)
    x = torch.zeros(1, 16, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        SSDScan.apply(x, torch.zeros(1, 16, 2), torch.zeros(1, 16, 4), torch.zeros(1, 16, 4), 16)


# --------------------------------------------------------------------------
# optimizers
# --------------------------------------------------------------------------

SCHEDULES = {
    "constant": (3e-2, 3e-2),
    "paper_decay": (jopt.paper_decay_schedule(0.1, 0.5, 1e-2),
                    topt.paper_decay_schedule(0.1, 0.5, 1e-2)),
    "cosine": (jopt.cosine_schedule(0.1, 3, warmup=1), topt.cosine_schedule(0.1, 3, warmup=1)),
}
OPTIMIZERS = {
    "sgd": lambda m, lr: m.sgd(lr),
    "sgd_momentum": lambda m, lr: m.sgd(lr, momentum=0.9),
    "adamw": lambda m, lr: m.adamw(lr, weight_decay=0.1),
}


def _tree(rng):
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "block": {"b": rng.standard_normal(5).astype(np.float32)}}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_three_steps_match_reference(name, schedule):
    rng = np.random.default_rng(0)
    jlr, tlr = SCHEDULES[schedule]
    jo, to = OPTIMIZERS[name](jopt, jlr), OPTIMIZERS[name](topt, tlr)
    params = _tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_jax(params, device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for _ in range(3):
        grads = _tree(rng)
        jp, js = jo.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts = to.update(params_from_jax(grads, device="cpu"), ts, tp)
        for g, w in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            assert_close(g, w, 1e-6)
        want = opt_state_from_jax(js, device="cpu")
        assert int(ts.step) == int(want.step)
        for got_tree, want_tree in ((ts.mu, want.mu), (ts.nu, want.nu)):
            if want_tree is None:
                assert got_tree is None
                continue
            for g, w in zip(tree_leaves(got_tree), tree_leaves(want_tree)):
                assert_close(g, w.numpy(), 1e-6)
    for step in range(4):
        if callable(jlr):
            assert_close(tlr(torch.tensor(step, dtype=torch.int32)),
                         jlr(jnp.asarray(step, jnp.int32)), 1e-6)


# --------------------------------------------------------------------------
# the JVP sketch
# --------------------------------------------------------------------------


def _lm_stats_case(n_fl=4, per=2):
    jcfg, tcfg, jp, batch = train_case("qwen2-0.5b", layers=1, b=n_fl * per, seed=6)
    jp = jax.tree.map(jnp.asarray, jp)
    jb, tb = {k: jnp.asarray(v) for k, v in batch.items()}, torch_batch(batch)

    def jloss(p):
        pe, _ = japi.model_loss(p, jcfg, jb, reduce=False)
        return pe.reshape(n_fl, per).mean(axis=1)

    def tloss(p):
        pe, _ = tapi.model_loss(p, tcfg, tb, reduce=False)
        return pe.reshape(n_fl, per).mean(dim=1)

    return jp, lm_params_from_jax(jp, tcfg, device="cpu"), jloss, tloss, jcfg, tcfg, jb, tb


def test_sketch_matches_reference_on_its_probes():
    jp, tp, jloss, tloss, *_ = _lm_stats_case()
    key = jax.random.PRNGKey(9)
    want = jax_sketch(jloss, jp, key, n_probes=3)
    # the reference's probes: one key a probe, then one a leaf in sorted-key order
    probes = [tree_unflatten(tp, jax_leaf_normals(kp, tp)) for kp in jax.random.split(key, 3)]
    got = tsketch.sketch_device_stats(tloss, tp, probes)
    for f in ("mean", "var", "norm"):
        assert_close(getattr(got, f), getattr(want, f))


def test_exact_device_stats_match_reference():
    jp, tp, _, _, jcfg, tcfg, jb, tb = _lm_stats_case(n_fl=2, per=2)

    def jgrad(p, i):
        sl = {k: jax.lax.dynamic_slice_in_dim(v, i * 2, 2) for k, v in jb.items()}
        return jax.grad(lambda q: japi.model_loss(q, jcfg, sl)[0])(p)

    def tgrad(p, i):
        sl = {k: v[i * 2:(i + 1) * 2] for k, v in tb.items()}
        return tree_unflatten(p, port_value_and_grad(
            lambda q: tapi.model_loss(q, tcfg, sl)[0], p)[1])

    want, _ = jax_exact_stats(jgrad, jp, 2)
    got, none = tsketch.exact_device_stats(tgrad, tp, 2)
    assert none is None
    for f in ("mean", "var", "norm"):
        assert_close(getattr(got, f), getattr(want, f))


def _quadratic(seed, n_dev=6, dim=200):
    """L_d(p) = ½‖p − c_d‖², so g_d = −c_d at p = 0 (``tests/test_sketch.py``)."""
    centers = torch.tensor(np.random.default_rng(seed).standard_normal((n_dev, dim)),
                           dtype=torch.float32)
    return (lambda p: 0.5 * ((p["p"][None, :] - centers) ** 2).sum(-1),
            {"p": torch.zeros(dim)}, -centers)


def test_sketch_mean_is_exact_and_norm_unbiased_on_the_port_generator():
    f, params, g = _quadratic(2)
    true_norms = torch.linalg.vector_norm(g, dim=-1)
    errs = []
    for probes in (8, 128):
        stats = tsketch.sketch_device_stats(
            f, params, tsketch.draw_probes(params, probes, torch.Generator().manual_seed(3)))
        assert_close(stats.mean, g.mean(-1).numpy())
        assert bool((stats.var >= 0).all())
        errs.append(float(((stats.norm - true_norms).abs() / true_norms).mean()))
    assert errs[1] < errs[0], errs      # the error shrinks with probes
    assert errs[1] < 0.15, errs         # ~sqrt(2/128) ≈ 0.12


# --------------------------------------------------------------------------
# the token corpus
# --------------------------------------------------------------------------


@pytest.mark.parametrize("vocab", [100, 4096])
def test_token_dataset_law(vocab):
    """Tokens lie below min(vocab, 256); each token's observed successors
    are a sparse set, about 0.31 of the effective vocabulary (Gumbel > 1
    leaves a share exp(−exp(−1)) ≈ 0.31 of each row); one generator seed
    gives one corpus."""
    toks = make_token_dataset(256, 256, vocab, torch.Generator().manual_seed(0))
    eff = min(vocab, 256)
    assert toks.shape == (256, 256) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < eff
    pairs = torch.unique(toks[:, :-1] * eff + toks[:, 1:])
    succ = torch.bincount(pairs // eff, minlength=eff).float()
    counts = torch.bincount(toks[:, :-1].reshape(-1), minlength=eff)
    seen = succ[counts >= 400] / eff  # the tokens the chain visits often
    assert len(seen) >= 10
    assert float((succ / eff).max()) < 0.5 and 0.15 < float(seen.mean()) < 0.4, seen
    again = make_token_dataset(256, 256, vocab, torch.Generator().manual_seed(0))
    assert torch.equal(toks, again)
