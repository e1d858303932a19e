"""The port's fault-tolerant lattice sweeps (``repro_torch.sim.resilience``)
on the CPU.

``tests/test_resilience.py``'s contract for the port: the ``REPRO_FAULT_*``
parsing, ``shard_bounds``, resume at every checkpoint boundary bitwise equal
to the uninterrupted run (also a churn / Dirichlet-mixed FedDyn lattice with
the taps and the quarantine's flags in its records), a foreign checkpoint
refused, pruning, ``run_worker_shard`` + ``merge_shards`` equal to the full
run, a NaN fault confined to its cell, and a worker process killed by
``REPRO_FAULT_KILL`` (exit 113) resumed bitwise on its rerun. Then
``run_lattice_checkpointed`` against the reference's on the reference's
draws (replayed per seed) at 1e-5, interrupted and resumed on the port's
side; and the scoped cuDNN deterministic flag.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_parity import assert_records_match, lattice_case

from repro.sim import resilience as jres
from repro_torch.core.pofl import POFLConfig
from repro_torch.data.partition import partition_dirichlet_mixed
from repro_torch.data.synthetic import make_classification_dataset
from repro_torch.models import small
from repro_torch.obs import ObsConfig
from repro_torch.sim import resilience as res
from repro_torch.sim.lattice import LatticeSpec, run_lattice
from repro_torch.sim.tasks import make_model_task

SRC = str(Path(__file__).resolve().parents[1] / "src")
FIELDS = ("e_com", "e_var", "grad_norm", "n_scheduled", "loss", "acc")


def _assert_bitwise(a, b) -> None:
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(a.eval_rounds, b.eval_rounds)
    for sub in ("diag", "eval", "health"):
        x, y = getattr(a, sub), getattr(b, sub)
        assert (x is None) == (y is None), sub
        if x is not None:
            for f in x._fields:
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f), err_msg=f)


def _task():
    return make_model_task("logreg", n_devices=6, n_train=60, n_test=12, device="cpu")


def _spec(**kw):
    return LatticeSpec(**{**dict(policies=("pofl", "channel"), seeds=(0, 1), n_rounds=7,
                                 eval_every=3), **kw})


def _run(task, spec, **kw):
    kw.setdefault("base_cfg", POFLConfig(n_devices=6, n_scheduled=2))
    return res.run_lattice_checkpointed(task.loss_fn, task.data, task.params0, spec,
                                        eval_fn=task.eval, device="cpu", **kw)


# -- the fault env contract -------------------------------------------------


def test_fault_env_parsing(monkeypatch):
    monkeypatch.delenv("REPRO_FAULT_KILL", raising=False)
    monkeypatch.delenv("REPRO_FAULT_NAN", raising=False)
    assert res.fault_kill() is None and res.fault_nan() is None
    monkeypatch.setenv("REPRO_FAULT_KILL", "1:4")
    monkeypatch.setenv("REPRO_FAULT_NAN", " 3:2 ")
    assert res.fault_kill() == jres.fault_kill() == (1, 4)
    assert res.fault_nan() == jres.fault_nan() == (3, 2)
    monkeypatch.setenv("REPRO_FAULT_KILL", "garbage")
    with pytest.raises(ValueError, match="REPRO_FAULT_KILL"):
        res.fault_kill()
    assert res.FAULT_EXIT_CODE == jres.FAULT_EXIT_CODE == 113
    assert res.FAULT_ENV_VARS == jres.FAULT_ENV_VARS


def test_fault_nan_rounds_slicing(monkeypatch):
    monkeypatch.delenv("REPRO_FAULT_NAN", raising=False)
    np.testing.assert_array_equal(res.fault_nan_rounds(0, 3), [-1, -1, -1])
    monkeypatch.setenv("REPRO_FAULT_NAN", "5:7")
    for lo, hi in ((4, 8), (0, 4), (5, 6)):
        np.testing.assert_array_equal(res.fault_nan_rounds(lo, hi),
                                      jres.fault_nan_rounds(lo, hi))
    np.testing.assert_array_equal(res.fault_nan_rounds(4, 8), [-1, 7, -1, -1])


def test_shard_bounds_tile_exactly():
    for n_cells, count in ((8, 2), (7, 3), (5, 5), (3, 2), (24, 4)):
        spans = [res.shard_bounds(n_cells, r, count) for r in range(count)]
        assert spans == [jres.shard_bounds(n_cells, r, count) for r in range(count)]
        assert spans[0][0] == 0 and spans[-1][1] == n_cells
        assert all(hi == lo for (_, hi), (lo, _) in zip(spans, spans[1:]))
    with pytest.raises(ValueError):
        res.shard_bounds(8, 2, 2)


# -- checkpoint/resume bit-identity ---------------------------------------------


def test_checkpointed_run_is_run_lattice(tmp_path):
    """The chunked rounds are ``run_lattice``'s: bitwise equal on the CPU,
    with a chunk that ends short (7 rounds, every 3)."""
    task, spec = _task(), _spec()
    full = _run(task, spec, checkpoint=res.CheckpointConfig(dir=str(tmp_path), every=3))
    plain = run_lattice(task.loss_fn, task.data, task.params0, spec,
                        base_cfg=POFLConfig(n_devices=6, n_scheduled=2), eval_fn=task.eval,
                        device="cpu")
    _assert_bitwise(full, plain)
    assert res.latest_checkpoint(str(tmp_path))[0] == 7


def test_resume_any_boundary_bit_identical(tmp_path):
    task, spec = _task(), _spec()
    full = _run(task, spec, checkpoint=res.CheckpointConfig(dir=str(tmp_path / "full"), every=3))
    for boundary in (3, 6):
        ck = res.CheckpointConfig(dir=str(tmp_path / f"stop{boundary}"), every=3)
        assert _run(task, spec, checkpoint=ck, _stop_after_round=boundary) is None
        assert res.latest_checkpoint(ck.dir)[0] == boundary
        _assert_bitwise(full, _run(task, spec, checkpoint=ck))


def test_resume_churn_dirichlet_feddyn_bit_identical(tmp_path, monkeypatch):
    """The stateful cell: churn over Gauss-Markov fading, Dirichlet-mixed
    shards, FedAvg and FedDyn fused, K = 2, with the taps and a NaN fault
    under the quarantine: the resumed carry holds the channel state and
    FedDyn's h, and the records' diag and health go through the npz."""
    x, y = make_classification_dataset("mnist_like", 160, torch.Generator().manual_seed(1))
    data = partition_dirichlet_mixed(x, y, n_devices=8, seed=0)
    params0 = small.init_logreg(torch.Generator().manual_seed(0))
    spec = LatticeSpec(policies=("pofl",), seeds=(0, 1), n_rounds=5,
                       algorithms=("fedavg", "feddyn"))
    monkeypatch.setenv("REPRO_FAULT_NAN", "3:1")
    kw = dict(base_cfg=POFLConfig(n_devices=8, n_scheduled=3, local_steps=2,
                                  on_nonfinite="skip"),
              scenario="churn", scenario_params={"base": "gauss_markov"},
              obs=ObsConfig(diagnostics=True), device="cpu")
    run = lambda d, **extra: res.run_lattice_checkpointed(  # noqa: E731
        small.logreg_loss, data, params0, spec,
        checkpoint=res.CheckpointConfig(dir=str(tmp_path / d), every=2), **kw, **extra)
    full = run("full")
    assert run("stop", _stop_after_round=2) is None
    resumed = run("stop")
    _assert_bitwise(full, resumed)
    assert full.health.nonfinite.reshape(4, -1)[3].tolist() == [0, 1, 0, 0, 0]
    assert full.health.nonfinite.sum() == 1 and np.isfinite(full.diag.noise_eff).all()


def test_resume_refuses_foreign_fingerprint(tmp_path):
    task, spec = _task(), _spec(n_rounds=4)
    ck = res.CheckpointConfig(dir=str(tmp_path), every=2)
    assert _run(task, spec, checkpoint=ck, _stop_after_round=2) is None
    with pytest.raises(ValueError, match="different sweep"):
        _run(task, spec, checkpoint=ck, base_cfg=POFLConfig(n_devices=6, n_scheduled=3))
    with pytest.raises(ValueError, match="different sweep"):
        _run(task, _spec(n_rounds=4, seeds=(0, 2)), checkpoint=ck)


def test_checkpoint_pruning_keeps_newest(tmp_path):
    task = _task()
    _run(task, _spec(n_rounds=6, seeds=(0,)),
         checkpoint=res.CheckpointConfig(dir=str(tmp_path), every=2, keep=1))
    assert sorted(os.listdir(tmp_path)) == ["ckpt-000006.meta.json", "ckpt-000006.npz"]


def test_checkpoint_every_needs_a_dir():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _run(_task(), _spec(), checkpoint_every=2)
    with pytest.raises(ValueError, match=">= 1"):
        res.CheckpointConfig(dir="x", every=0)


# -- worker shards ------------------------------------------------------------


def test_shard_merge_matches_full_run(tmp_path):
    """Three workers' slices of a 2-algorithm grid (cells of one seed on
    both sides of a cut), merged: the full checkpointed run's records."""
    task, spec = _task(), _spec(n_rounds=4, algorithms=("fedavg", "scaffold"))
    kw = dict(base_cfg=POFLConfig(n_devices=6, n_scheduled=2), eval_fn=task.eval,
              device="cpu")
    full = res.run_lattice_checkpointed(task.loss_fn, task.data, task.params0, spec, **kw)
    paths = []
    for rank in range(3):
        paths.append(str(tmp_path / f"shard{rank}.npz"))
        lo, hi = res.run_worker_shard(task.loss_fn, task.data, task.params0, spec, paths[-1],
                                      str(tmp_path / "ck"), 2, rank=rank, count=3, **kw)
        assert (lo, hi) == res.shard_bounds(spec.n_cells, rank, 3)
    _assert_bitwise(full, res.merge_shards(spec, paths))
    with pytest.raises(ValueError, match="tile"):
        res.merge_shards(spec, paths[1:])


def test_nan_fault_is_confined_to_its_cell(monkeypatch):
    """``REPRO_FAULT_NAN`` poisons one flat cell at one round: under "skip"
    only that cell is flagged, and every other cell is bitwise the
    no-fault run."""
    task, spec = _task(), _spec(n_rounds=4)
    cfg = POFLConfig(n_devices=6, n_scheduled=2, on_nonfinite="skip")
    clean = _run(task, spec, base_cfg=cfg)
    monkeypatch.setenv("REPRO_FAULT_NAN", "2:1")
    faulted = _run(task, spec, base_cfg=cfg)
    flags = faulted.health.nonfinite.reshape(spec.n_cells, -1)
    assert flags[2].tolist() == [0, 1, 0, 0] and flags.sum() == 1
    for f in FIELDS:
        got = getattr(faulted, f).reshape(spec.n_cells, -1)
        want = getattr(clean, f).reshape(spec.n_cells, -1)
        np.testing.assert_array_equal(np.delete(got, 2, axis=0), np.delete(want, 2, axis=0))
    assert np.isnan(faulted.grad_norm.reshape(spec.n_cells, -1)[2, 1])  # ||ŷ|| of NaNs


_WORKER = """
import sys, torch
torch.set_num_threads(1)
from repro_torch.core.pofl import POFLConfig
from repro_torch.sim.lattice import LatticeSpec
from repro_torch.sim.resilience import run_worker_shard
from repro_torch.sim.tasks import make_model_task
task = make_model_task("logreg", n_devices=6, n_train=60, n_test=12, device="cpu")
spec = LatticeSpec(policies=("pofl", "channel"), seeds=(0, 1), n_rounds=5, eval_every=2)
run_worker_shard(task.loss_fn, task.data, task.params0, spec, sys.argv[1], sys.argv[2], 2,
                 base_cfg=POFLConfig(n_devices=6, n_scheduled=2), eval_fn=task.eval,
                 device="cpu")
"""


def test_killed_worker_exits_113_and_resumes_bit_identical(tmp_path):
    """A worker process (rank 1 of 2 by the ``REPRO_DIST_*`` env) under
    ``REPRO_FAULT_KILL=1:2`` exits 113 at the checkpoint after round 2; its
    rerun without the fault resumes there, and its shard equals an
    uninterrupted worker's bitwise."""
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_DIST_PROCESS_ID="1",
               REPRO_DIST_NUM_PROCESSES="2")
    env.pop("REPRO_FAULT_NAN", None)

    def worker(out, ck, **extra):
        return subprocess.run([sys.executable, "-c", _WORKER, out, ck],
                              env={**env, **extra}, capture_output=True, text=True,
                              timeout=300)

    killed = worker(str(tmp_path / "f.npz"), str(tmp_path / "ck_f"), REPRO_FAULT_KILL="1:2")
    assert killed.returncode == 113, killed.stderr[-2000:]
    assert res.latest_checkpoint(str(tmp_path / "ck_f" / "r1"))[0] == 4
    assert not (tmp_path / "f.npz").exists()
    for out, ck in (("f.npz", "ck_f"), ("c.npz", "ck_c")):
        done = worker(str(tmp_path / out), str(tmp_path / ck))
        assert done.returncode == 0, done.stderr[-2000:]
    with np.load(tmp_path / "f.npz") as f, np.load(tmp_path / "c.npz") as c:
        assert f.files == c.files
        for k in f.files:
            np.testing.assert_array_equal(f[k], c[k], err_msg=k)


# -- against the reference ---------------------------------------------------------


def test_checkpointed_run_matches_reference(monkeypatch, tmp_path):
    """The reference's ``run_lattice_checkpointed`` and the port's on the
    reference's draws (replayed per seed, through the port's npz): two
    algorithms × two policies, the taps on, the port interrupted at round
    2 and resumed. Records, taps and eval within 1e-5."""
    case = lattice_case(monkeypatch, dict(policies=("pofl", "channel"),
                                          algorithms=("fedavg", "feddyn")),
                        dict(backend="pallas_fused"), n_rounds=5, diagnostics=True)
    ref_kw = {k: v for k, v in case.reference.keywords.items()}
    want = jres.run_lattice_checkpointed(*case.reference.args, **ref_kw,
                                         checkpoint_every=2,
                                         checkpoint_dir=str(tmp_path / "ref"))
    kw = dict(case.port_kw, obs=ObsConfig(diagnostics=True), device="cpu",
              checkpoint_every=2, checkpoint_dir=str(tmp_path / "port"))
    assert res.run_lattice_checkpointed(**kw, _stop_after_round=2) is None
    got = res.run_lattice_checkpointed(**kw)
    assert_records_match(got, want)
    assert got.diag is not None


# -- the scoped deterministic mode ------------------------------------------------


def test_cudnn_deterministic_is_scoped_and_restored():
    """On a CUDA device the flag is set inside and restored on exit, also
    after an exception; on the CPU nothing changes."""
    before = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = False
        with res.cudnn_deterministic("cpu"):
            assert torch.backends.cudnn.deterministic is False
        with res.cudnn_deterministic(torch.device("cuda")):
            assert torch.backends.cudnn.deterministic is True
        assert torch.backends.cudnn.deterministic is False
        with pytest.raises(RuntimeError, match="mid-chunk"):
            with res.cudnn_deterministic("cuda"):
                raise RuntimeError("mid-chunk")
        assert torch.backends.cudnn.deterministic is False
        torch.backends.cudnn.deterministic = True
        with res.cudnn_deterministic("cuda"):
            pass
        assert torch.backends.cudnn.deterministic is True
    finally:
        torch.backends.cudnn.deterministic = before
