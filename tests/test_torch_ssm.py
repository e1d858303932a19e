"""The port's Mamba2 (ssm) serving path held against the live reference on the CPU.

Inputs come from numpy with a seed; weights from the reference's
``model_init`` (or ``init_mamba2``), carried over by
``repro_torch.convert.lm_params_from_jax``, with the zero biases and unit
norm scales and skip weights of a fresh init replaced by seeded numpy
values so that they count. Every comparison is fp32 within 1e-5 relative
to the reference's scale (``_torch_parity``) unless it says otherwise;
greedy tokens match exactly, and at every step the reference's top-2 logit
margin is asserted to exceed that tolerance, so the greedy choice is well
defined.

The SSD scan's plain versions are held to the reference's oracles and to
its Pallas kernel in interpret mode on the cases of ``tests/test_kernels.py``;
the CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import RTOL, assert_close, t
from jax.sharding import AxisType

from repro import configs as jconfigs
from repro.kernels.ssd.kernel import ssd_pallas
from repro.kernels.ssd.ref import ssd_chunked_ref as jax_ssd_chunked
from repro.kernels.ssd.ref import ssd_naive as jax_ssd_naive
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.kernels.ssd import kernel as tkernel
from repro_torch.kernels.ssd import ops as tops
from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_naive
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import cache as tcache
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.models.config import InputShape

# --------------------------------------------------------------------------
# the SSD scan's plain versions
# --------------------------------------------------------------------------

# (b, s, h, p, n, chunk): the cases of tests/test_kernels.py:132-147 (the
# chunked scan against the naive one, and the Pallas kernel against both),
# one chunk (s == chunk) and several
SSD_CASES = {
    "naive_2x64": (2, 64, 4, 32, 16, 16),
    "naive_1x128": (1, 128, 2, 64, 64, 32),
    "one_chunk": (3, 32, 8, 16, 8, 32),
    "pallas_2x32": (2, 32, 8, 16, 8, 16),
}
PALLAS_CASES = ["naive_2x64", "naive_1x128", "pallas_2x32"]
# tests/test_kernels.py's own limit for the Pallas kernel in bf16 against the
# fp32 naive scan (rtol = atol)
BF16_NAIVE_TOL = 8e-2


def _ssd_inputs(b, s, h, p, n, seed, dtype=np.float32):
    """xdt, B, C standard normal; la in [-3, -0.01), the reference test's range."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(dtype),
            -rng.uniform(0.01, 3.0, (b, s, h)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(dtype),
            rng.standard_normal((b, s, n)).astype(dtype))


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_plain_versions_match_reference(case):
    b, s, h, p, n, chunk = SSD_CASES[case]
    args = _ssd_inputs(b, s, h, p, n, seed=len(case))
    jargs, targs = [jnp.asarray(a) for a in args], [t(a) for a in args]
    assert_close(ssd_naive(*targs), jax_ssd_naive(*jargs))
    got = ssd_chunked_ref(*targs, chunk)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, p)
    assert_close(got, jax_ssd_chunked(*jargs, chunk))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PALLAS_CASES)
def test_ssd_plain_version_matches_pallas_kernel(case, dtype):
    """fp32 within 1e-5. bf16: the plain version on bf16 inputs and the
    Pallas kernel both within tests/test_kernels.py's limit of the fp32 naive
    scan, and the plain version run in fp32 on the same inputs and rounded
    once within one bf16 rounding of the kernel, element by element (the
    kernel accumulates in fp32 and rounds y once: the card's limit)."""
    b, s, h, p, n, chunk = SSD_CASES[case]
    xdt, la, B, C = _ssd_inputs(b, s, h, p, n, seed=len(case) + 1)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    want = ssd_pallas(jnp.asarray(xdt, jdt), jnp.asarray(la), jnp.asarray(B, jdt),
                      jnp.asarray(C, jdt), chunk=chunk, interpret=True)
    txdt, tB, tC = (torch.tensor(a).to(tdt) for a in (xdt, B, C))
    got = ssd_chunked_ref(txdt, t(la), tB, tC, chunk)
    assert got.dtype == tdt and got.shape == (b, s, h, p) and torch.isfinite(got).all()
    if dtype == "float32":
        assert_close(got, want)
        return
    xr, Br, Cr = (jnp.asarray(a, jnp.bfloat16).astype(jnp.float32) for a in (xdt, B, C))
    naive = np.asarray(jax_ssd_naive(xr, jnp.asarray(la), Br, Cr))
    for out in (got.float().numpy(), np.asarray(want, np.float32)):
        np.testing.assert_allclose(out, naive, rtol=BF16_NAIVE_TOL, atol=BF16_NAIVE_TOL)
    once = ssd_chunked_ref(txdt.float(), t(la), tB.float(), tC.float(), chunk)
    ref = once.numpy()
    limit = 2.0**-8 * np.abs(ref) + 1e-5 * max(1.0, float(np.abs(ref).max()))
    assert (np.abs(np.asarray(want, np.float32) - ref) <= limit).all()
    assert (np.abs(once.to(torch.bfloat16).float().numpy() - ref) <= limit).all()


def test_ssd_op_dispatches_cpu_tensors_to_plain_version_and_checks_the_chunk():
    args = [t(a) for a in _ssd_inputs(2, 48, 3, 16, 8, seed=5)]
    before = tkernel.launches
    assert torch.equal(tops.ssd(*args, chunk=16), ssd_chunked_ref(*args, 16))
    assert tkernel.launches == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        tops.ssd(*args, chunk=32)


def test_ssd_kernel_wrapper_refuses_cpu_tensors_and_building_waits_for_a_call():
    args = [t(a) for a in _ssd_inputs(1, 16, 2, 16, 8, seed=6)]
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.ssd_scan(*args, chunk=16)
    assert tkernel.build.cache_info().currsize == 0


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def _cfg(layers=2, **kw):
    """reduced_config("mamba2-370m") (d 256, d_state 16, 16 heads of 32,
    chunk 16, conv 4, vocab 512) with ``layers`` layers, on both sides."""
    return tuple(dataclasses.replace(c.reduced_config("mamba2-370m"), n_layers=layers, **kw)
                 for c in (jconfigs, tconfigs))


def _perturbed(tree, seed):
    """The tree with the conv bias, dt bias, skip weight D and norm scales
    set to seeded numpy values (a fresh init has zeros and ones there)."""
    rng = np.random.default_rng(seed)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if key in ("conv_b", "dt_bias"):
            return rng.standard_normal(a.shape).astype(np.float32) * 0.3
        if key in ("scale", "D"):
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return walk(tree)


def _layer_params(cfg, seed, mamba2_dt=False):
    """One layer's ``ln1`` and ``mamba`` leaves. ``mamba2_dt`` draws
    dt_bias as Mamba2 initialises it (arXiv:2405.21060's code: dt log-uniform
    in [1e-3, 1e-1], dt_bias its inverse softplus)."""
    jp = _perturbed({"ln1": jlayers.init_rmsnorm(cfg.d_model),
                     "mamba": jlayers.init_mamba2(jax.random.PRNGKey(seed), cfg)}, seed + 1)
    if mamba2_dt:
        nh = cfg.ssm.n_heads(cfg.d_model)
        dt = np.exp(np.random.default_rng(seed + 2).uniform(np.log(1e-3), np.log(1e-1), nh))
        jp["mamba"]["dt_bias"] = (dt + np.log(-np.expm1(-dt))).astype(np.float32)
    return jax.tree.map(jnp.asarray, jp), params_from_jax(jp, device="cpu")


def test_causal_conv1d_matches_reference():
    rng = np.random.default_rng(0)
    xbc = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    assert_close(tlayers.causal_conv1d(t(xbc), t(w), t(b)),
                 jlayers.causal_conv1d(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("s", [16, 48])
def test_mamba2_fwd_matches_reference(s):
    """One chunk and three chunks of 16."""
    cfg, tcfg = _cfg()
    jp, tp = _layer_params(cfg, 1)
    x = np.random.default_rng(s).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    assert_close(tlayers.mamba2_fwd(tp["mamba"], t(x), tcfg),
                 jlayers.mamba2_fwd(jp["mamba"], jnp.asarray(x), cfg))


def test_mamba2_decode_matches_reference():
    cfg, tcfg = _cfg()
    jp, tp = _layer_params(cfg, 2)
    s = cfg.ssm
    di, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    state = rng.standard_normal((2, nh, s.d_state, s.head_dim)).astype(np.float32)
    conv = rng.standard_normal((2, s.conv_kernel - 1, di + 2 * s.d_state)).astype(np.float32)
    want = jlayers.mamba2_decode(jp["mamba"], jnp.asarray(x), cfg, jnp.asarray(state),
                                 jnp.asarray(conv))
    got = tlayers.mamba2_decode(tp["mamba"], t(x), tcfg, t(state), t(conv))
    for g, w in zip(got, want):  # output, new state, new conv state
        assert_close(g, w)


@pytest.mark.parametrize("s", [16, 48, 7])
def test_mamba_layer_with_state_matches_reference(s):
    """A prompt of one chunk, of three, and one shorter than a chunk (the
    scan then runs in one chunk of 7)."""
    cfg, tcfg = _cfg()
    jp, tp = _layer_params(cfg, 4)
    x = np.random.default_rng(s + 1).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    want = jtransformer._mamba_layer_with_state(jp, jnp.asarray(x), cfg, jnp.float32)
    got = ttransformer._mamba_layer_with_state(tp, t(x), tcfg, torch.float32)
    for g, w in zip(got, want):  # output, final state, conv state
        assert_close(g, w)


def test_ragged_prompt_longer_than_a_chunk_raises_as_the_reference_does():
    """20 tokens at chunk 16: the reference asserts s % chunk == 0; the port
    raises ValueError and adds no ragged chunk."""
    cfg, tcfg = _cfg()
    jp, tp = _layer_params(cfg, 5)
    x = np.zeros((1, 20, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        jtransformer._mamba_layer_with_state(jp, jnp.asarray(x), cfg, jnp.float32)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        ttransformer._mamba_layer_with_state(tp, t(x), tcfg, torch.float32)


def test_one_layer_at_full_width_matches_reference():
    """mamba2-370m's widths (d 1024, d_state 128, 32 heads of 64, conv 4,
    chunk 256) for one layer, batch 1, a prompt of 512 (two chunks): the
    output, final state and conv state of the prefill layer, then one
    decode step from them.

    dt_bias is Mamba2's (``_layer_params``). At the reference's zero dt_bias
    (dt ≈ 0.7, decays to -54 a token) La reaches -8,000 over the prompt,
    where one ulp of La (5e-4) is that much of a decay weight: both sides
    are then only within 1.3e-5 of the float64 result, and the frameworks'
    in_proj sums (1e-6 apart) move y by 2.2e-5 (ROADMAP queue C)."""
    cfg, tcfg = (c.get_config("mamba2-370m") for c in (jconfigs, tconfigs))
    s = cfg.ssm
    assert (cfg.d_model, s.d_state, s.n_heads(cfg.d_model), s.head_dim, s.chunk_size) == (
        1024, 128, 32, 64, 256)
    jp, tp = _layer_params(cfg, 6, mamba2_dt=True)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 512, cfg.d_model)).astype(np.float32)
    want = jtransformer._mamba_layer_with_state(jp, jnp.asarray(x), cfg, jnp.float32)
    got = ttransformer._mamba_layer_with_state(tp, t(x), tcfg, torch.float32)
    for g, w in zip(got, want):
        assert_close(g, w)
    x1 = rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32)
    want = jlayers.mamba2_decode(jp["mamba"], jnp.asarray(x1), cfg, want[1], want[2])
    got = tlayers.mamba2_decode(tp["mamba"], t(x1), tcfg, got[1], got[2])
    for g, w in zip(got, want):
        assert_close(g, w)


# --------------------------------------------------------------------------
# the model: forward, prefill, decode
# --------------------------------------------------------------------------


def _model(cfg, tcfg, seed=0):
    jp = _perturbed(japi.model_init(cfg, jax.random.PRNGKey(seed)), seed + 100)
    return jax.tree.map(jnp.asarray, jp), lm_params_from_jax(jp, tcfg, device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _assert_margin(logits):
    """The reference's top-2 margin exceeds the tolerance in every row."""
    top2 = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    assert margin.min() > RTOL * np.abs(top2).max(), margin.min()


@pytest.mark.parametrize("s", [16, 48])
def test_forward_prefill_and_six_decode_steps_match_reference(s):
    """The reduced mamba2 (2 layers, untied head) on a prompt of exactly one
    chunk and of three: logits, SSM state and conv window after the prefill
    and after six greedy decode steps, tokens equal."""
    cfg, tcfg = _cfg()
    jp, tp = _model(cfg, tcfg, seed=s)
    toks = _tokens(cfg, 2, s, s + 1)
    want_logits, _ = jtransformer.forward(jp, cfg, jnp.asarray(toks))
    got_logits, aux = ttransformer.forward(tp, tcfg, t(toks, torch.int64))
    assert_close(got_logits, want_logits)
    assert float(aux) == 0.0

    wl, wcache = jtransformer.prefill(jp, cfg, jnp.asarray(toks))
    gl, gcache = ttransformer.prefill(tp, tcfg, t(toks, torch.int64))
    assert isinstance(gcache, tcache.SSMCache)
    assert_close(gl, wl)
    for got, want in zip(gcache, wcache):
        assert_close(got, want)
    wtok = jnp.argmax(wl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    gtok = gl[:, -1].argmax(dim=-1, keepdim=True)
    _assert_margin(wl[:, -1])
    for i in range(6):
        assert np.array_equal(gtok.numpy(), np.asarray(wtok))
        wl, wcache = jtransformer.decode_step(jp, cfg, wtok, wcache, jnp.asarray(s + i))
        gl, out = ttransformer.decode_step(tp, tcfg, gtok, gcache, s + i)
        assert out is gcache  # updated in place
        assert_close(gl, wl)
        _assert_margin(wl[:, -1])
        wtok = jnp.argmax(wl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        gtok = gl[:, -1].argmax(dim=-1, keepdim=True)
    assert np.array_equal(gtok.numpy(), np.asarray(wtok))
    for got, want in zip(gcache, wcache):
        assert_close(got, want)


# --------------------------------------------------------------------------
# serving: serve_demo and Server.decode
# --------------------------------------------------------------------------


def _auto_mesh():
    """A one-device mesh with Auto axes, as tests/test_torch_lm.py builds it."""
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


@pytest.fixture
def reference_weights(monkeypatch):
    """The port's ``model_init`` replaced by the reference's draws, so that
    both ``serve_demo``s serve the same weights."""
    def init(cfg, seed=0, device=None):
        return lm_params_from_jax(japi.model_init(cfg, jax.random.PRNGKey(seed)), cfg, device)
    monkeypatch.setattr(tapi, "model_init", init)


def test_serve_demo_matches_reference(reference_weights):
    cfg, tcfg = _cfg()
    toks = _tokens(cfg, 2, 32, 21)
    want, _ = jserve.serve_demo(cfg, _auto_mesh(), {"tokens": jnp.asarray(toks)}, n_tokens=6,
                                dtype=jnp.float32, seed=3)
    got, stats = tserve.serve_demo(tcfg, {"tokens": t(toks, torch.int64)}, n_tokens=6,
                                   dtype=torch.float32, seed=3, device="cpu")
    assert got.shape == (2, 6) and np.array_equal(got.numpy(), np.asarray(want))
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0


def test_server_decode_matches_reference():
    """Prefill, then ``Server.decode`` of 6 tokens on both sides: the same
    tokens and the same SSM state and conv window; ``pad_cache`` leaves an
    SSM cache as it is."""
    cfg, tcfg = _cfg()
    jp, tp = _model(cfg, tcfg, seed=5)
    s, n = 32, 6
    toks = _tokens(cfg, 2, s, 22)
    shape = InputShape("serve", seq_len=s + n, global_batch=2, kind="decode")
    jsrv = jserve.Server(cfg, shape, _auto_mesh(), dtype=jnp.float32)
    tsrv = tserve.Server(tcfg, shape, "cpu", dtype=torch.float32)
    wl, wcache = japi.model_prefill(jp, cfg, {"tokens": jnp.asarray(toks)}, jnp.float32)
    first, gl, gcache = tsrv.prefill(tp, {"tokens": t(toks, torch.int64)})
    assert_close(gl, wl)
    assert np.array_equal(first.numpy(), np.asarray(jnp.argmax(wl[:, -1], -1)[:, None]))
    assert tcache.pad_cache(gcache, s + n) is gcache
    want, wcache = jsrv.decode(jsrv.load_params(jp), jnp.asarray(first.numpy(), jnp.int32),
                               wcache, start_t=s, n_tokens=n)
    got, gcache = tsrv.decode(tsrv.load_params(tp), first, gcache, start_t=s, n_tokens=n)
    assert isinstance(gcache, tcache.SSMCache)
    assert np.array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(gcache, wcache):
        assert_close(a, b)


def test_server_keeps_the_fp32_leaves_and_casts_the_rest_once():
    """In bf16 the reference still reads A_log, dt_bias and the norm scales
    in fp32 (dt and the log decay are fp32); every other leaf is cast."""
    cfg, tcfg = _cfg(layers=1)
    _, tp = _model(cfg, tcfg, seed=9)
    srv = tserve.Server(tcfg, InputShape("s", seq_len=40, global_batch=2, kind="decode"),
                        "cpu", dtype=torch.bfloat16)
    cast = srv.load_params(tp)
    m = cast["layers"]["mamba"]
    assert cast["embed"].dtype == m["in_proj"].dtype == m["D"].dtype == torch.bfloat16
    assert m["A_log"].dtype == m["dt_bias"].dtype == m["norm"]["scale"].dtype == torch.float32
    assert torch.equal(m["A_log"], tp["layers"]["mamba"]["A_log"])
    toks = torch.tensor(_tokens(cfg, 2, 32, 10), dtype=torch.int64)
    first, logits, cache = srv.prefill(cast, {"tokens": toks})
    out, cache = srv.decode(cast, first, cache, 32, 3)
    assert cache.state.dtype == torch.bfloat16 and out.shape == (2, 3)
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()


# --------------------------------------------------------------------------
# entry points, caches and conversion
# --------------------------------------------------------------------------


def test_init_cache_and_pad_cache_for_ssm():
    cfg, tcfg = _cfg()
    want = japi.init_cache(cfg, 3, 40)
    got = tapi.init_cache(tcfg, 3, 40, device="cpu")
    assert isinstance(got, tcache.SSMCache)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and not g.any()
    assert tcache.pad_cache(got, 100) is got


def test_ssm_entry_points_need_a_card_or_an_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.reduced_config("mamba2-370m")
    shape = InputShape("s", seq_len=10, global_batch=2, kind="decode")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.model_init(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.init_cache(cfg, 2, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.Server(cfg, shape)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve_demo(cfg, {"tokens": torch.zeros((2, 4), dtype=torch.int64)}, n_tokens=2)


def test_lm_params_from_jax_carries_an_ssm_tree_and_checks_shapes():
    cfg, tcfg = _cfg()
    jp = japi.model_init(cfg, jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jp, tcfg, device="cpu")
    di = cfg.ssm.d_inner(cfg.d_model)
    assert tp["layers"]["mamba"]["out_proj"].shape == (2, di, cfg.d_model)
    assert "lm_head" in tp and "attn" not in tp["layers"]  # untied head, no attention
    with pytest.raises(ValueError, match="expected"):
        lm_params_from_jax(jp, dataclasses.replace(tcfg, n_layers=3), device="cpu")
    wider = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, d_state=32))
    with pytest.raises(ValueError, match="in_proj"):
        lm_params_from_jax(jp, wider, device="cpu")


def test_port_init_model_has_the_reference_shapes():
    cfg, tcfg = _cfg()
    want = japi.model_init(cfg, jax.random.PRNGKey(0))
    got = tapi.model_init(tcfg, seed=0, device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32, path
    assert torch.allclose(got["layers"]["mamba"]["A_log"], t(want["layers"]["mamba"]["A_log"]))
