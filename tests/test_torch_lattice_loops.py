"""The port's per-policy and per-algorithm lattice loops
(``run_lattice(fuse_policies=False)``, ``run_lattice(fuse_algorithms=False)``)
held against the reference's same call and against the port's fused grid
(CPU).

A small logreg lattice (8 devices, 3 scheduled, batch 2, 2 seeds, 3
rounds, eval every 2, ``pallas_fused``; the reference's kernels
interpreted), the reference's draws replayed per seed. Each sub-lattice of
a loop draws from the same seeds' streams as the fused grid, so every cell
consumes the same draws. Tolerance: against the reference 1e-5 relative to
each cell's scale, against the port's fused grid 1e-6 (the sub-lattices
batch fewer cells); |S|, correct counts and health flags exactly equal.
"""
from __future__ import annotations

import pytest
import torch
from _torch_parity import assert_records_match, lattice_case

import repro_torch.kernels.aircomp as aircomp_ops

LOOP_TOL = 1e-6

# name: (spec axes, config, the loop's run_lattice options, the scenario)
LOOPS = {
    "per_policy": (dict(policies=("pofl", "channel", "deterministic")), {},
                   dict(fuse_policies=False), {}),
    "per_algorithm": (dict(algorithms=("fedavg", "feddyn", "scaffold"),
                           policies=("pofl", "channel")),
                      dict(local_steps=2, feddyn_alpha=0.2),
                      dict(fuse_algorithms=False), {}),
    "both_under_skip_and_dropout": (
        dict(algorithms=("fedprox", "scaffold"), policies=("pofl", "importance")),
        dict(local_steps=2, fedprox_mu=0.3, on_nonfinite="skip"),
        dict(fuse_policies=False, fuse_algorithms=False),
        dict(scenario="dropout", scenario_params=dict(base="gauss_markov", corr=0.9,
                                                      p_drop=0.4), task_eval=True)),
}


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_loop_matches_reference_and_the_fused_grid(loop, monkeypatch):
    spec_kw, cfg_kw, loop_kw, case_kw = LOOPS[loop]
    case = lattice_case(monkeypatch, spec_kw, dict(backend="pallas_fused", **cfg_kw),
                        **case_kw)
    want = case.reference(**loop_kw)
    fused = case.port()
    calls = []
    plain = aircomp_ops.aircomp_aggregate_fused_batch

    def counting(g, *args):
        calls.append(tuple(g.shape))
        return plain(g, *args)

    monkeypatch.setattr(aircomp_ops, "aircomp_aggregate_fused_batch", counting)
    got = case.port(**loop_kw)
    assert_records_match(got, want)
    assert_records_match(got, fused, rtol=LOOP_TOL)
    # the trial-batched aggregation runs once a sub-lattice a round, on its cells
    n_alg, n_pol = len(got.axes["algorithm"]), len(got.axes["policy"])
    subs = (1 if loop_kw.get("fuse_algorithms", True) else n_alg) * (
        1 if loop_kw.get("fuse_policies", True) else n_pol)
    cells = n_alg * n_pol * len(got.axes["seed"])
    rounds = got.e_com.shape[-1]
    assert len(calls) == subs * rounds
    assert {c[0] for c in calls} == {cells // subs}


def test_one_algorithm_spec_keeps_its_static_dispatch_without_fusing(monkeypatch):
    """``fuse_algorithms=False`` over one algorithm changes nothing: the
    records are bitwise the fused call's."""
    case = lattice_case(monkeypatch, dict(algorithms=("feddyn",), policies=("pofl",)),
                        dict(backend="pallas_fused", local_steps=2))
    fused, loop = case.port(), case.port(fuse_algorithms=False)
    for f in ("e_com", "e_var", "grad_norm", "n_scheduled", "loss", "acc"):
        assert torch.equal(torch.as_tensor(getattr(loop, f)), torch.as_tensor(getattr(fused, f)))
