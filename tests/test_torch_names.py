"""The port's public names held against the reference's (CPU).

Every name the reference's ``repro.core``, ``repro.data``, ``repro.optim``
and ``repro.kernels.ssd`` export, the public names of its
``repro.launch.{steps,train,mesh,sharding,dryrun}``, and ``SimState``, imports from the
port's counterpart; the forward functions take ``remat`` (ROADMAP C11); the record and config schemas agree field for field and in
order; and the names this slice adds compute what the reference's do on the
same inputs: ``make_round_step`` over a chain of rounds on the reference's
key discipline, ``power_check``, ``bound_objective``,
``pad_with_wrong_labels`` and ``ssd_pallas``. Tolerance: floats within
1e-5 of the reference relative to its scale, decisions exactly equal.
"""
from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    assert_close, cfg_to_torch, data_to_torch, jax_batch_idx, jax_noise, jax_sched_draw,
    reference_task, t,
)
from jax.flatten_util import ravel_pytree as jax_ravel

from repro.core import aircomp as jair
from repro.core import metrics as jmetrics
from repro.core import pofl as jpofl
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.core.channel import ChannelState as JChannelState
from repro.data import synthetic as jsynth
from repro.kernels.ssd.kernel import ssd_pallas as jax_ssd_pallas
from repro.sim import engine as jengine
from repro_torch.convert import params_from_jax
from repro_torch.core import aircomp as tair
from repro_torch.core import metrics as tmetrics
from repro_torch.core import pofl as tpofl
from repro_torch.core.channel import ChannelConfig, ChannelState
from repro_torch.data import synthetic as tsynth
from repro_torch.flatten_util import ravel_pytree
from repro_torch.kernels.ssd import ssd_pallas
from repro_torch.sim.engine import RoundDraws

# the reference's repro.sim exports of its engine and compile caches, which
# the port has no counterpart of while it compiles nothing (ROADMAP A17)
SIM_LATER = ("cached_engine", "enable_compile_cache", "engine_cache_stats",
             "lattice_compile_stats", "lattice_memory_stats", "persistent_cache_counters",
             "reset_engine_cache")

# (reference package, port package, names the port does not have yet)
PACKAGES = [("repro.core", "repro_torch.core", ()),
            ("repro.data", "repro_torch.data", ()),
            ("repro.optim", "repro_torch.optim", ()),
            ("repro.kernels.ssd", "repro_torch.kernels.ssd", ()),
            ("repro.obs", "repro_torch.obs", ()),
            ("repro.checkpoint", "repro_torch.checkpoint", ()),
            ("repro.sim", "repro_torch.sim", SIM_LATER)]


@pytest.mark.parametrize("ref,port,later", PACKAGES)
def test_every_reference_export_imports_from_the_port(ref, port, later):
    ref_mod, port_mod = importlib.import_module(ref), importlib.import_module(port)
    names = [n for n in ref_mod.__all__ if n not in later]
    missing = [n for n in names if n not in port_mod.__all__ or not hasattr(port_mod, n)]
    assert not missing, missing


# the reference dry run's readers of a compiled XLA program (its HLO text
# and its cost analysis), which the port has no counterpart of while it
# compiles nothing: its dry run reckons from the specs
DRYRUN_NO_PROGRAM = ("parse_collective_bytes", "cost_analysis_dict")


@pytest.mark.parametrize("module", ["steps", "train", "mesh", "sharding", "dryrun"])
def test_launch_modules_have_the_reference_public_names(module):
    """Every function and class a ``repro.launch`` training module defines
    (not imports) without a leading underscore, in the port's module (but
    DRYRUN_NO_PROGRAM)."""
    import inspect

    ref = importlib.import_module(f"repro.launch.{module}")
    port = importlib.import_module(f"repro_torch.launch.{module}")
    names = [n for n, v in vars(ref).items() if not n.startswith("_")
             and (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == ref.__name__
             and n not in DRYRUN_NO_PROGRAM]
    assert names
    assert not [n for n in names if not hasattr(port, n)]


@pytest.mark.parametrize("fn", ["transformer.backbone", "transformer.forward",
                                "encdec._decoder_hidden", "encdec.forward_encdec"])
def test_forward_functions_take_remat(fn):
    """ROADMAP C11: the reference's forward functions take ``remat``; so do
    the port's, at the same position with the same default."""
    import inspect

    module, name = fn.split(".")
    ref = getattr(importlib.import_module(f"repro.models.{module}"), name)
    port = getattr(importlib.import_module(f"repro_torch.models.{module}"), name)
    want, got = inspect.signature(ref).parameters, inspect.signature(port).parameters
    assert list(got).index("remat") == list(want).index("remat")
    assert got["remat"].default == want["remat"].default


def test_the_port_exports_the_slice_names():
    """``repro_torch.core`` exports the diagnostics taps and
    ``repro_torch.sim`` the checkpointed sweep's names, ``shard_bounds``
    with them; the taps' and the records' schemas are the reference's."""
    from repro.sim import resilience as jres
    from repro_torch import core, sim
    from repro_torch.obs import ObsConfig

    assert core.RoundDiagnostics is tmetrics.RoundDiagnostics
    assert core.diagnostics_taps is tmetrics.diagnostics_taps
    assert tmetrics.RoundDiagnostics._fields == jmetrics.RoundDiagnostics._fields
    assert {"run_lattice_checkpointed", "run_worker_shard", "merge_shards",
            "shard_bounds", "CheckpointConfig", "latest_checkpoint"} <= set(sim.__all__)
    assert sim.shard_bounds(7, 2, 3) == jres.shard_bounds(7, 2, 3)
    assert [f.name for f in dataclasses.fields(sim.CheckpointConfig)] == [
        f.name for f in dataclasses.fields(jres.CheckpointConfig)]
    assert jengine.RoundRecord._fields == sim.engine.RoundRecord._fields
    assert ObsConfig() == ObsConfig(diagnostics=False)


def test_named_imports_and_schemas_match_the_reference():
    from repro_torch.core import BACKENDS, POFLConfig, make_round_step, run_pofl  # noqa: F401
    from repro_torch.kernels.ssd import ssd_pallas  # noqa: F401
    from repro_torch.sim import SimState

    assert BACKENDS == jpofl.BACKENDS
    assert SimState._fields == jengine.SimState._fields
    assert tmetrics.RoundMetrics._fields == jmetrics.RoundMetrics._fields
    assert tmetrics.RoundHealth._fields == jmetrics.RoundHealth._fields
    assert [f.name for f in dataclasses.fields(POFLConfig)] == [
        f.name for f in dataclasses.fields(jpofl.POFLConfig)]
    # a positional config carries over
    values = (12, 4, 0.2, "channel")
    assert cfg_to_torch(jpofl.POFLConfig(*values)) == POFLConfig(*values)
    for name in ("local_gradient_stage", "ChannelState"):
        assert hasattr(tpofl, name)
    assert tmetrics.safe_div is not None
    health = tmetrics.zero_round_health()
    assert health._fields == jmetrics.zero_round_health()._fields
    assert float(health.nonfinite) == float(jmetrics.zero_round_health().nonfinite) == 0.0


def test_make_round_step_matches_reference():
    """The reference's ``make_round_step`` chained over 4 rounds on its key
    discipline (``tests/test_sim.py``'s legacy loop), the port's step fed
    the same round's draws as tensors: params and metrics every round."""
    data, jparams, jloss, _, tloss, *_ = reference_task("logreg", 10, per_device=8)
    jcfg = jpofl.POFLConfig(n_devices=10, n_scheduled=4, batch_size=2, policy="pofl",
                            noise_power=1e-10, seed=3)
    dim = jax_ravel(jparams)[0].size
    key = jax.random.PRNGKey(jcfg.seed)
    k_chan_init, key = jax.random.split(key)
    jccfg = JChannelConfig(n_devices=10, tx_power=jcfg.tx_power, noise_power=jcfg.noise_power)
    jchannel = JChannelState.create(jccfg, k_chan_init)
    channel = ChannelState(cfg=ChannelConfig(n_devices=10, noise_power=jcfg.noise_power),
                           gains=t(jchannel.gains))
    jstep = jpofl.make_round_step(jloss, data, jchannel, jcfg)
    step = tpofl.make_round_step(tloss, data_to_torch(data), channel, cfg_to_torch(jcfg))
    jp, tp = jparams, params_from_jax(jparams, device="cpu")
    for r in range(4):
        key, k_round = jax.random.split(key)
        jp, jm = jstep(jp, k_round, jnp.asarray(r, jnp.float32))
        k_batch, k_chan, k_sched, k_noise = jax.random.split(k_round, 4)
        draws = RoundDraws(h=t(jchannel.sample(k_chan)),
                           batch_idx=jax_batch_idx(data, jcfg.batch_size, k_batch),
                           sched=jax_sched_draw(jcfg, k_sched), z=jax_noise(k_noise, dim),
                           avail=torch.ones(10))
        tp, tm = step(tp, draws, r)
        assert_close(ravel_pytree(tp)[0], jax_ravel(jp)[0])
        assert float(tm.n_scheduled) == float(jm.n_scheduled)
        for f in ("e_com", "e_var", "grad_norm", "a_scalar"):
            assert_close(getattr(tm, f), getattr(jm, f))
        assert tm.health is None and jm.health is None


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_power_check_matches_reference(scale):
    """Eq. 6 at Lemma 1's own a (holds) and at 4× it (fails for some)."""
    ks = jax.random.split(jax.random.PRNGKey(7), 3)
    n = 12
    h = (jax.random.normal(ks[0], (n,)) + 1j * jax.random.normal(ks[1], (n,))) * 1e-3
    h = h.astype(jnp.complex64)
    rho = jax.random.uniform(ks[2], (n,), minval=0.01, maxval=0.3)
    mask = jnp.ones(n)
    a = jair.denoise_scalar(rho, jnp.abs(h), mask, 1.0) * scale
    want = np.asarray(jair.power_check(rho, h, a, 1.0))
    got = tair.power_check(t(rho), t(h), t(a), 1.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.all() if scale == 1.0 else not want.all()


def test_bound_objective_matches_reference():
    e_com = np.asarray([1e-3, 0.5, 2.0], np.float32)
    e_var = np.asarray([3e-2, 0.1, 0.0], np.float32)
    for alpha in (0.05, 0.1, 0.7):
        want = jmetrics.bound_objective(jnp.asarray(e_com), jnp.asarray(e_var), alpha)
        assert_close(tmetrics.bound_objective(t(e_com), t(e_var), alpha), want)


def test_pad_with_wrong_labels_matches_reference():
    feats = np.random.default_rng(3).normal(size=(5, 4)).astype(np.float32)
    labels = np.asarray([0, 9, 3, 3, 7], np.int32)
    want_f, want_l = jsynth.pad_with_wrong_labels(feats, labels, 7)
    got_f, got_l = tsynth.pad_with_wrong_labels(torch.tensor(feats),
                                                torch.tensor(labels, dtype=torch.int64), 7)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    assert ((got_l[5:] - got_l[torch.arange(7) % 5]) % 10 == 1).all()


def test_ssd_pallas_matches_reference_kernel_interpreted():
    """``ssd_pallas`` by the reference's name and default chunk, on a CPU
    tensor its plain version, against the Pallas kernel interpreted."""
    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 512, 2, 16, 8
    xdt = rng.normal(size=(b, s, h, p)).astype(np.float32) * 0.1
    la = -np.abs(rng.normal(size=(b, s, h))).astype(np.float32) * 0.1
    B, C = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))
    want = jax_ssd_pallas(*(jnp.asarray(a) for a in (xdt, la, B, C)), interpret=True)
    assert_close(ssd_pallas(*(t(a) for a in (xdt, la, B, C))), want)
