"""The port's flight recorder (``repro_torch.obs``) and diagnostics taps held
against the reference (CPU).

  * registry, spans and the JSONL sink: the contract of ``tests/test_obs.py``
    (prefix-scoped resets, process stamps from the ``REPRO_DIST_*`` env,
    torn lines skipped, a killed writer's events durable, one file per
    process of a two-process run);
  * ``diagnostics_taps`` against the reference's on the same inputs (a
    deep-fade channel and a zero-probability device make ``eps_clamps`` >
    0), one round and one cell-batched round with ``diagnostics=True``
    against the reference's on shared draws, and the lattice's ``diag``
    grid on the fused path and both loops;
  * the engine's events: ``lattice.run`` / ``lattice.diagnostics``, the
    warm-lattice gate passing, and failing on a warm ``compile_delta``;
    diagnostics off leaves ``diag`` ``None`` and every record bitwise what
    a run with the taps gives; ``REPRO_OBS_PROFILE`` writes a trace.

Tolerance: taps within 1e-5 of the reference relative to their scale,
``eps_clamps`` exactly equal (``_torch_parity``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    assert_close, cfg_to_torch, data_to_torch, jax_batch_idx, jax_engine_draws, jax_noise,
    jax_sched_draw, reference_task, t,
)
from jax.flatten_util import ravel_pytree as jax_ravel

from repro.core import metrics as jmetrics
from repro.core import pofl as jpofl
from repro.core import scheduling as jsched
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.sim import engine as jengine
from repro_torch.convert import params_from_jax
from repro_torch.core import metrics as tmetrics
from repro_torch.core import pofl as tpofl
from repro_torch.flatten_util import ravel_pytree
from repro_torch.obs import (
    ObsConfig, close_sink, counter, counter_add, emit, event_files, gauge, metric_value,
    metrics_snapshot, process_coords, read_events, reset_metrics, span, span_totals,
)
from repro_torch.obs.report import collect, gate_warm_lattice, render
from repro_torch.obs.report import main as report_main
from repro_torch.sim import engine as tengine
from repro_torch.sim.lattice import LatticeSpec, run_lattice
from repro_torch.sim.tasks import make_model_task

SRC = str(Path(__file__).resolve().parents[1] / "src")
N = 8


@pytest.fixture(autouse=True)
def _fresh_sink():
    """Every test starts and ends with no open sink handle and none of the
    metrics the tests here touch."""
    close_sink()
    yield
    close_sink()
    for prefix in ("t.", "ns1.", "ns2.", "span.t."):
        reset_metrics(prefix)


# -- registry, spans and the sink -------------------------------------------


def test_counter_and_gauge_basics():
    assert metric_value("t.c") == 0
    assert counter_add("t.c") == 1
    assert counter_add("t.c", 2.5) == 3.5
    c = counter("t.c")
    c.add(1)
    assert c.value == 4.5
    g = gauge("t.g")
    g.set(7)
    g.set(3)
    assert g.value == 3
    assert metrics_snapshot("t.") == {"t.c": 4.5, "t.g": 3}


def test_reset_metrics_is_prefix_scoped():
    counter_add("ns1.a")
    counter_add("ns2.b")
    reset_metrics("ns1.")
    assert metric_value("ns1.a") == 0
    assert metric_value("ns2.b") == 1


def test_span_records_registry_totals_and_propagates_exceptions():
    with span("t.work") as s:
        pass
    assert s.seconds is not None and s.seconds >= 0
    with pytest.raises(ValueError, match="boom"):
        with span("t.work"):
            raise ValueError("boom")
    assert span_totals("t.work")["count"] == 2
    assert span_totals("t.work")["seconds"] >= 0

    @span("t.deco")
    def f(x):
        return x + 1

    assert f(1) == 2
    assert span_totals("t.deco")["count"] == 1


def test_sink_inactive_without_env(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_OBS_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    ev = emit("counter", "t.quiet", delta=1, total=1)
    assert ev["kind"] == "counter" and ev["name"] == "t.quiet"
    assert os.listdir(tmp_path) == []  # nothing written anywhere


def test_sink_writes_process_stamped_jsonl(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_OBS_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_DIST_PROCESS_ID", "1")
    monkeypatch.setenv("REPRO_DIST_NUM_PROCESSES", "2")
    assert process_coords() == (1, 2)
    with span("t.stamped", tag="x"):
        pass
    counter_add("t.stamped.extra")
    close_sink()
    files = event_files(str(tmp_path))
    assert len(files) == 1
    assert os.path.basename(files[0]).startswith("events-p001of002-")
    events = list(read_events(str(tmp_path)))
    assert {e["kind"] for e in events} == {"span", "counter"}
    for e in events:
        assert (e["process_index"], e["process_count"], e["pid"]) == (1, 2, os.getpid())
    (sp,) = [e for e in events if e["kind"] == "span"]
    assert sp["name"] == "t.stamped" and sp["tag"] == "x"


def test_process_coords_default_and_malformed(monkeypatch):
    monkeypatch.delenv("REPRO_DIST_PROCESS_ID", raising=False)
    monkeypatch.delenv("REPRO_DIST_NUM_PROCESSES", raising=False)
    assert process_coords() == (0, 1)
    monkeypatch.setenv("REPRO_DIST_PROCESS_ID", "x")
    assert process_coords() == (0, 1)


def test_read_events_skips_torn_lines(tmp_path):
    p = tmp_path / "events-p000of001-1.jsonl"
    p.write_text('{"kind": "counter", "name": "ok"}\n{"kind": "half\n\n')
    events = list(read_events(str(tmp_path)))
    assert len(events) == 1 and events[0]["name"] == "ok"


def test_sink_survives_killed_writer(tmp_path):
    """A writer that dies hard (``os._exit``, as ``REPRO_FAULT_KILL`` does)
    loses at most its torn trailing line."""
    script = (
        "import os\n"
        f"os.environ['REPRO_OBS_DIR'] = {str(tmp_path)!r}\n"
        "from repro_torch.obs.sink import _handle, emit, obs_dir\n"
        "for i in range(3):\n"
        "    emit('heartbeat', 'killed.writer', i=i)\n"
        "h = _handle(obs_dir())\n"
        "h.write('{\"kind\": \"torn mid-li')\n"
        "os._exit(137)\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 137, proc.stderr[-2000:]
    events = [e for e in read_events(str(tmp_path)) if e["name"] == "killed.writer"]
    assert [e["i"] for e in events] == [0, 1, 2]


_WORKER = """
import torch
torch.set_num_threads(1)
from repro_torch.core.pofl import POFLConfig
from repro_torch.sim.lattice import LatticeSpec, run_lattice
from repro_torch.sim.tasks import make_model_task
task = make_model_task("logreg", n_devices=4, n_train=40, n_test=8, device="cpu")
spec = LatticeSpec(policies=("pofl", "channel"), seeds=(0, 1), n_rounds=2)
for _ in range(2):  # cold, then a warm repeat
    run_lattice(task.loss_fn, task.data, task.params0, spec,
                base_cfg=POFLConfig(n_devices=4, n_scheduled=2), device="cpu")
"""


def test_two_process_workers_write_one_sink_file_each(tmp_path):
    """Two worker processes under one ``REPRO_OBS_DIR`` (ranks from the
    ``REPRO_DIST_*`` env) write one file each, stamped with their rank, and
    record the same sweeps and lattice runs."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER],
        env=dict(os.environ, PYTHONPATH=SRC, REPRO_OBS_DIR=str(tmp_path),
                 REPRO_DIST_PROCESS_ID=str(rank), REPRO_DIST_NUM_PROCESSES="2"),
        stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
    names = sorted(os.path.basename(f) for f in event_files(str(tmp_path)))
    assert len(names) == 2
    assert names[0].startswith("events-p000of002-") and names[1].startswith("events-p001of002-")
    summary = collect(read_events(str(tmp_path)))
    assert summary["processes"] == {0, 1}
    runs = {rank: [(e["warm"], e["trace_delta"], e["compile_delta"]) for e in summary["lattice"]
                   if e["process_index"] == rank] for rank in (0, 1)}
    assert runs[0] == runs[1] == [(False, 0, 0), (True, 0, 0)]
    for rank in (0, 1):
        assert summary["spans"][(rank, "lattice.sweep")]["count"] == 2
    assert gate_warm_lattice(summary) == []


# -- the diagnostics taps ------------------------------------------------------

def _tap_inputs(seed, fade=False, zero_prob=False):
    """probs, ||g_i||, V_g, a, |h| of N devices; ``fade`` puts two devices
    in a deep fade (P|h|² below EPS), ``zero_prob`` gives one probability
    0."""
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.ones(N)).astype(np.float32)
    if zero_prob:
        probs[3] = 0.0
        probs /= probs.sum()
    h_abs = rng.uniform(1e-4, 1e-2, N).astype(np.float32)
    if fade:
        h_abs[[1, 6]] = 1e-16
    norms = rng.uniform(0.1, 2.0, N).astype(np.float32)
    return probs, norms, np.float32(rng.uniform(0.01, 1.0)), np.float32(rng.uniform(0.1, 5.0)), \
        h_abs


@pytest.mark.parametrize("fade,zero_prob,noise", [
    (False, False, 1e-10), (True, False, 1e-10), (False, True, 1e-8), (True, True, 0.0)])
def test_diagnostics_taps_match_reference(fade, zero_prob, noise):
    probs, norms, v_g, a, h_abs = _tap_inputs(7, fade, zero_prob)
    want = jmetrics.diagnostics_taps(*(jnp.asarray(x) for x in (probs, norms, v_g, a, h_abs)),
                                     1.0, noise)
    got = tmetrics.diagnostics_taps(*(t(x) for x in (probs, norms, v_g, a, h_abs)), 1.0, noise)
    assert got._fields == want._fields
    assert float(got.eps_clamps) == float(want.eps_clamps) == fade * 2 + zero_prob
    for f in ("noise_eff", "sched_entropy", "grad_norm_spread"):
        assert_close(getattr(got, f), getattr(want, f))


def test_diagnostics_taps_of_an_empty_schedule_and_a_degenerate_v_g():
    """a = inf (nothing scheduled) gives noise 0; V_g = 0 counts a clamp."""
    probs, norms, _, _, h_abs = _tap_inputs(3)
    args = (probs, norms, np.float32(0.0), np.float32(np.inf), h_abs)
    want = jmetrics.diagnostics_taps(*(jnp.asarray(x) for x in args), 1.0, 1e-10)
    got = tmetrics.diagnostics_taps(*(t(x) for x in args), 1.0, 1e-10)
    assert float(got.noise_eff) == float(want.noise_eff) == 0.0
    assert float(got.eps_clamps) == float(want.eps_clamps) == 1.0
    assert_close(got.sched_entropy, want.sched_entropy)


@pytest.mark.parametrize("backend", ["jnp", "pallas_fused"])
@pytest.mark.parametrize("policy", ["pofl", "noisefree"])
def test_one_round_with_diagnostics_matches_reference(backend, policy, monkeypatch):
    """``round_algorithm(diagnostics=True)`` on the reference's draws: the
    taps, and the round's params and metrics as without them."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    data, jparams, jloss, _, tloss, *_ = reference_task("logreg", N, per_device=8)
    jcfg = jpofl.POFLConfig(n_devices=N, n_scheduled=3, batch_size=2, policy=policy,
                            backend=backend, noise_power=1e-10)
    dim = jax_ravel(jparams)[0].size
    h = next(jax_engine_draws(jcfg, JChannelConfig(n_devices=N), data, dim, seed=3)).h
    k_batch, k_sched, k_noise = jax.random.split(jax.random.PRNGKey(9), 3)
    want_p, _, want_m = jpofl.round_algorithm(
        jloss, data, jcfg, jparams, jnp.asarray(h.numpy()), k_batch, k_sched, k_noise,
        jnp.float32(2), diagnostics=True)
    args = (tloss, data_to_torch(data), cfg_to_torch(jcfg),
            params_from_jax(jparams, device="cpu"), h,
            jax_batch_idx(data, jcfg.batch_size, k_batch), jax_sched_draw(jcfg, k_sched),
            jax_noise(k_noise, dim), 2)
    got_p, _, got_m = tpofl.round_algorithm(*args, diagnostics=True)
    off_p, _, off_m = tpofl.round_algorithm(*args)
    assert off_m.diag is None and isinstance(got_m.diag, tmetrics.RoundDiagnostics)
    assert torch.equal(ravel_pytree(got_p)[0], ravel_pytree(off_p)[0])
    assert all(torch.equal(a, b) for a, b in zip(got_m[:6], off_m[:6]))
    assert_close(ravel_pytree(got_p)[0], jax_ravel(want_p)[0])
    assert float(got_m.diag.eps_clamps) == float(want_m.diag.eps_clamps)
    for f in ("noise_eff", "sched_entropy", "grad_norm_spread"):
        assert_close(getattr(got_m.diag, f), getattr(want_m.diag, f))
    if policy == "noisefree":
        assert float(got_m.diag.noise_eff) == 0.0


def test_cell_batched_round_with_diagnostics_matches_reference_per_cell(monkeypatch):
    """``round_algorithm_cells(diagnostics=True)``: each cell's taps against
    the reference's ``round_algorithm(policy_id=..., diagnostics=True)``."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    data, jparams0, jloss, _, tloss, *_ = reference_task("logreg", N, per_device=8)
    jcfg = jpofl.POFLConfig(n_devices=N, n_scheduled=2, batch_size=2, backend="pallas_fused",
                            policy=jengine.FUSED_POLICY)
    flat0, unravel = jax_ravel(jparams0)
    dim = flat0.size
    cells = [("pofl", 1e-10, 0.1), ("noisefree", 1e-9, 0.2), ("deterministic", 1e-10, 0.3),
             ("channel", 1e-8, 0.1)]
    want, states, draws = [], [], []
    for c, (policy, s2, alpha) in enumerate(cells):
        jparams = unravel(flat0 * (1.0 + 0.1 * c))
        h = next(jax_engine_draws(jcfg, JChannelConfig(n_devices=N), data, dim, seed=c)).h
        k_batch, k_sched, k_noise = jax.random.split(jax.random.PRNGKey(10 + c), 3)
        want.append(jpofl.round_algorithm(
            jloss, data, jcfg, jparams, jnp.asarray(h.numpy()), k_batch, k_sched, k_noise,
            jnp.float32(2), noise_power=jnp.float32(s2), alpha=jnp.float32(alpha),
            policy_id=jnp.int32(jsched.policy_id(policy)), diagnostics=True)[2])
        states.append(params_from_jax(jparams, device="cpu"))
        draws.append((h, jax_batch_idx(data, jcfg.batch_size, k_batch),
                      jax_sched_draw(jcfg, k_sched), jax_noise(k_noise, dim)))
    params_c = {k: torch.stack([s[k] for s in states]) for k in states[0]}
    _, _, got = tpofl.round_algorithm_cells(
        tloss, data_to_torch(data), cfg_to_torch(jcfg), params_c,
        *[torch.stack(x) for x in zip(*draws)], 2, torch.tensor([c[1] for c in cells]),
        torch.tensor([c[2] for c in cells]),
        torch.tensor([jsched.policy_id(c[0]) for c in cells]), diagnostics=True)
    assert isinstance(got.diag, tmetrics.RoundDiagnostics) and got.diag.noise_eff.shape == (4,)
    for c, want_m in enumerate(want):
        assert float(got.diag.eps_clamps[c]) == float(want_m.diag.eps_clamps)
        for f in ("noise_eff", "sched_entropy", "grad_norm_spread"):
            assert_close(getattr(got.diag, f)[c], getattr(want_m.diag, f))


# -- the lattice's taps and events --------------------------------------------------


def _small_lattice(n_rounds=3, **spec_kw):
    task = make_model_task("logreg", n_devices=6, n_train=60, n_test=12, device="cpu")
    spec = LatticeSpec(**{**dict(policies=("pofl", "channel", "noisefree"), seeds=(0, 1),
                                 n_rounds=n_rounds, eval_every=2), **spec_kw})
    cfg = tpofl.POFLConfig(n_devices=6, n_scheduled=2)
    return task, spec, cfg


def _run(task, spec, cfg, **kw):
    return run_lattice(task.loss_fn, task.data, task.params0, spec, base_cfg=cfg,
                       eval_fn=task.eval, device="cpu", **kw)


def test_diagnostics_off_is_default_and_leaves_the_records_unchanged():
    """Off: ``diag`` is ``None``. On: the taps only read, so every base
    record is bitwise the one of the run without them."""
    task, spec, cfg = _small_lattice(algorithms=("fedavg", "scaffold"))
    off = _run(task, spec, cfg)
    on = _run(task, spec, cfg, obs=ObsConfig(diagnostics=True))
    assert off.diag is None
    for f in ("e_com", "e_var", "grad_norm", "n_scheduled", "loss", "acc"):
        np.testing.assert_array_equal(getattr(on, f), getattr(off, f), err_msg=f)
    d = on.diag
    assert isinstance(d, tmetrics.RoundDiagnostics)
    for f in d._fields:
        assert getattr(d, f).shape == (2, 3, 1, 1, 2, 3) and np.isfinite(getattr(d, f)).all()
    assert ((d.sched_entropy >= 0) & (d.sched_entropy <= np.log(6) + 1e-5)).all()
    assert (d.eps_clamps == 0).all() and (d.grad_norm_spread >= 0).all()
    assert (d.noise_eff[:, 2] == 0).all() and (d.noise_eff[:, :2] > 0).all()  # noisefree


@pytest.mark.parametrize("loop", ["fuse_policies", "fuse_algorithms"])
def test_loop_lattice_diagnostics_match_fused(loop):
    """The per-policy and per-algorithm loops give the fused grid's taps
    (``tests/test_obs.py``'s fallback case; bitwise on the CPU)."""
    task, spec, cfg = _small_lattice(n_rounds=2, algorithms=("fedavg", "feddyn"))
    obs = ObsConfig(diagnostics=True)
    fused = _run(task, spec, cfg, obs=obs)
    looped = _run(task, spec, cfg, obs=obs, **{loop: False})
    for f in fused.diag._fields:
        np.testing.assert_array_equal(getattr(looped.diag, f), getattr(fused.diag, f),
                                      err_msg=f)


def test_lattice_emits_events_and_gate_passes(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_OBS_DIR", str(tmp_path))
    task, spec, cfg = _small_lattice(n_rounds=2)
    _run(task, spec, cfg, obs=ObsConfig(diagnostics=True))
    _run(task, spec, cfg)  # a warm repeat
    _run(task, spec, cfg, fuse_policies=False)
    close_sink()
    summary = collect(read_events(str(tmp_path)))
    lat = summary["lattice"]
    assert len(lat) == 2 + len(spec.policies)  # one event per engine dispatch
    assert all(e["trace_delta"] == 0 and e["compile_delta"] == 0 and e["engine_compiles"] == 0
               for e in lat)
    assert [e["warm"] for e in lat[1:]] == [True] * (len(lat) - 1)
    assert lat[0]["cells"] == spec.n_cells and lat[0]["fused"] is True
    assert [e.get("policy") for e in lat[2:]] == list(spec.policies)
    assert all(e["cells"] == spec.n_cells // len(spec.policies) for e in lat[2:])
    (diag,) = summary["diag"]
    assert diag["name"] == "lattice.diagnostics" and diag["n_rounds"] == 2
    assert set(diag["taps"]) == set(tmetrics.RoundDiagnostics._fields)
    assert all(len(v) == 2 for v in diag["taps"].values())
    assert summary["spans"][(0, "lattice.sweep")]["count"] == 3
    assert summary["spans"][(0, "lattice.dispatch")]["count"] == 2 + len(spec.policies)
    assert gate_warm_lattice(summary) == []
    text = render(summary)
    assert "lattice runs" in text and "sched_entropy" in text
    assert report_main([str(tmp_path), "--gate-warm-lattice"]) == 0


def test_warm_run_that_builds_a_kernel_fails_the_gate(monkeypatch, tmp_path):
    """``compile_delta`` is the ``nvcc`` builds during the call: a warm run
    during which a kernel was built (a ``kernels.nvcc`` span, as
    ``kernels/build.py`` records one) fails the gate."""
    monkeypatch.setenv("REPRO_OBS_DIR", str(tmp_path))
    task, spec, cfg = _small_lattice(n_rounds=1)
    _run(task, spec, cfg)
    chunk = tengine.SimEngine.run_lattice_chunk

    def building_chunk(self, *args, **kw):
        with span("kernels.nvcc", source="fake.cu"):
            pass
        return chunk(self, *args, **kw)

    monkeypatch.setattr(tengine.SimEngine, "run_lattice_chunk", building_chunk)
    _run(task, spec, cfg)
    close_sink()
    summary = collect(read_events(str(tmp_path)))
    assert summary["lattice"][-1]["compile_delta"] == 1
    problems = gate_warm_lattice(summary)
    assert len(problems) == 1 and "compiled 1 new program" in problems[0]
    assert report_main([str(tmp_path), "--gate-warm-lattice"]) == 1
    reset_metrics("span.kernels.")


def test_report_gate_fails_on_a_warm_compile(tmp_path, capsys):
    bad = {"kind": "lattice", "name": "lattice.run", "process_index": 0, "cells": 4,
           "warm": True, "trace_delta": 0, "compile_delta": 2, "fused": True,
           "engine_compiles": 0}
    (tmp_path / "events-p000of001-1.jsonl").write_text(json.dumps(bad) + "\n")
    assert report_main([str(tmp_path), "--gate-warm-lattice"]) == 1
    assert "compiled 2 new program" in capsys.readouterr().err
    empty = tmp_path / "empty"
    empty.mkdir()
    assert report_main([str(empty), "--gate-warm-lattice"]) == 1  # nothing proven


def test_report_cli_runs_as_a_module(tmp_path):
    (tmp_path / "events-p000of001-1.jsonl").write_text(json.dumps(
        {"kind": "span", "name": "lattice.sweep", "seconds": 0.5}) + "\n")
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", str(tmp_path)],
                         env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "repro_torch.obs report" in out.stdout and "lattice.sweep" in out.stdout


def test_profile_captures_a_trace_of_the_lattice(monkeypatch, tmp_path):
    """``REPRO_OBS_PROFILE=1``: one Chrome trace a lattice dispatch under
    ``<REPRO_OBS_DIR>/profile/lattice`` with the rounds' ranges, and its
    ``profile`` event; the records are those of the unprofiled run."""
    task, spec, cfg = _small_lattice(n_rounds=1)
    plain = _run(task, spec, cfg)
    monkeypatch.setenv("REPRO_OBS_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_OBS_PROFILE", "1")
    profiled = _run(task, spec, cfg)
    close_sink()
    np.testing.assert_array_equal(profiled.e_var, plain.e_var)
    (ev,) = [e for e in read_events(str(tmp_path)) if e["kind"] == "profile"]
    assert ev["name"] == "lattice" and ev["cuda"] is False
    assert os.path.dirname(ev["trace"]) == str(tmp_path / "profile" / "lattice")
    names = {e.get("name") for e in json.load(open(ev["trace"]))["traceEvents"]}
    assert {"lattice.local_update", "lattice.aggregation"} <= names


def test_run_with_history_with_diagnostics_keeps_its_history():
    """``SimEngine(obs=...)`` computes the taps in ``run_with_history``
    too; its ``History``, as the reference's, carries none, and is bitwise
    the one without them."""
    task = make_model_task("logreg", n_devices=6, n_train=60, n_test=12, device="cpu")
    cfg = tpofl.POFLConfig(n_devices=6, n_scheduled=2, local_algorithm="feddyn")
    runs = [tengine.SimEngine(task.loss_fn, task.data, cfg, device="cpu", obs=obs)
            .run_with_history(task.params0, 4, eval_fn=task.eval, eval_every=2)
            for obs in (None, ObsConfig(diagnostics=True))]
    (p_off, h_off), (p_on, h_on) = runs
    assert h_on == h_off
    assert torch.equal(ravel_pytree(p_on)[0], ravel_pytree(p_off)[0])
