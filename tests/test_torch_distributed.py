"""The port's launcher (``python -m repro_torch.launch.distributed``) on the
CPU, against the reference's contract.

``worker_env`` writes the ``REPRO_DIST_*`` contract and the import roots and
refuses more than one device a rank; ``run_workers`` raises on a failed rank
and kills the ranks at its deadline; the ``parity`` workload on 2 gloo ranks
gives a single host's records (decisions exact, floats within 1e-6: a
rank's smaller cell batch may sum in another order), repeats itself
bitwise, its per-policy loop matches its fused grid within 1e-6, and every
round holds to the unsharded round from its state, over the cells mesh
within 1e-6 and over the (1, 2) model mesh within 1e-5 (so does its CNN
check, on a CNN of 4 devices); the supervised
``resilient`` workload with ``REPRO_FAULT_KILL=1:2`` merges bitwise to a
clean run's records with one ``resilience.fault_kill``, one
``supervisor.restart`` and one ``resilience.resume`` event; the ``serve``
workload's plan runs each run on the mesh its ``model`` field names.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from _torch_parity import launch_ranks

from repro.launch import distributed as jdist
from repro_torch.launch import distributed as tdist

ROOT = Path(__file__).resolve().parents[1]


def _launch(args: list[str], timeout: float = 240.0, **env) -> str:
    """The launcher's CLI with ``args`` (the ranks killed after ``timeout``
    seconds, the launcher a minute later) → its output."""
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.distributed", "--timeout", str(timeout),
         *args],
        capture_output=True, text=True, cwd=ROOT, timeout=timeout + 60,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1", **env})
    assert done.returncode == 0, done.stdout[-4000:] + done.stderr[-4000:]
    return done.stdout


def test_worker_env_writes_the_contract(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    env = tdist.worker_env("127.0.0.1:5555", 3, 2, base_env={"PYTHONPATH": "/x", "KEEP": "1"})
    want = jdist.worker_env("127.0.0.1:5555", 3, 2, 1, base_env={"PYTHONPATH": "/x"})
    for var in ("REPRO_DIST_COORDINATOR", "REPRO_DIST_NUM_PROCESSES", "REPRO_DIST_PROCESS_ID"):
        assert env[var] == want[var]
    # every rank on this host: its local place is its rank
    assert (env["REPRO_DIST_LOCAL_PROCESS_ID"], env["REPRO_DIST_LOCAL_NUM_PROCESSES"]) == ("2", "3")
    roots = env["PYTHONPATH"].split(os.pathsep)
    assert roots == [str(ROOT / "src"), str(tmp_path), "/x"]
    assert env["KEEP"] == "1" and "XLA_FLAGS" not in env
    with pytest.raises(ValueError, match="one rank a device"):
        tdist.worker_env("127.0.0.1:5555", 2, 0, devices_per_proc=4)
    assert [f.name for f in dataclasses.fields(tdist.SupervisorConfig)] == [
        f.name for f in dataclasses.fields(jdist.SupervisorConfig)]


def test_run_workers_raises_on_a_failed_rank():
    fail_rank_1 = [sys.executable, "-c",
                   "import os, sys; sys.exit(3 if os.environ['REPRO_DIST_PROCESS_ID'] == '1' "
                   "else 0)"]
    failed = r"(?s)1/2 distributed workers failed.*worker 1 \(rc=3\)"
    with pytest.raises(RuntimeError, match=failed):
        tdist.run_workers(fail_rank_1, n_procs=2, timeout=60)
    hang = [sys.executable, "-c", "import time; time.sleep(60)"]
    with pytest.raises(RuntimeError, match="killed at the 2.0s deadline"):
        tdist.run_workers(hang, n_procs=2, timeout=2.0)


def test_parity_workload_on_two_ranks_matches_a_single_host(tmp_path):
    out = tmp_path / "parity.npz"
    _launch(["--procs", "2", "--workload", "parity", "--device", "cpu", "--out", str(out)])
    got, meta = tdist.load_records(str(out))
    want, single = tdist.run_parity_lattice(device="cpu")
    assert got.axes == want.axes
    np.testing.assert_array_equal(got.eval_rounds, want.eval_rounds)
    for f in ("n_scheduled", "acc"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in ("e_com", "e_var", "grad_norm", "loss"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-6, atol=1e-12,
                                   err_msg=f)
    assert meta["process_count"] == 2 and meta["backend"] == "gloo"
    assert meta["repeat_exact"] and single["repeat_exact"]
    assert meta["fused_vs_fallback"].pop("decisions_equal")
    assert max(meta["fused_vs_fallback"].values()) <= 1e-6
    for key, tol in (("rounds_from_state", 1e-6), ("model_rounds_from_state", 1e-5)):
        for rnd in meta[key]:
            assert rnd.pop("decisions_equal") and max(rnd.values()) <= tol
    assert len(meta["per_rank"]) == 2


def test_cnn_parity_holds_every_round_from_the_unsharded_state(tmp_path):
    """The parity workload's CNN check (``--cnn-rounds``) on the CNN with 4
    devices over 2 ranks (3 cells: 2 + 1, padded to 4): each lattice round
    over the cells mesh within 1e-6 of the unsharded round from its state,
    over the (1, 2) model mesh and each model-sharded ``round_algorithm``
    (metrics and new params) within 1e-5, decisions exact; the
    sharded calls timed on their own, and no kernel launched on the CPU."""
    out = launch_ranks("cnn_parity", 2, None, tmp_path)
    none = {"aircomp_fused": 0, "aircomp_fused_batch": 0}
    for part, key in (("cells", "sharded"), ("model", "sharded"),
                      ("model", "round_algorithm_sharded")):
        assert out[part][key] == {"timed": True, "launches": none}
    for part, key, tol in (("cells", "rounds_from_state", 1e-6),
                           ("model", "rounds_from_state", 1e-5),
                           ("model", "round_algorithm_from_state", 1e-5)):
        assert len(out[part][key]) == 2
        for rnd in out[part][key]:
            assert rnd.pop("decisions_equal") and max(rnd.values()) <= tol


def test_supervised_resilient_run_survives_a_kill_bitwise(tmp_path):
    common = ["--procs", "2", "--workload", "resilient", "--device", "cpu",
              "--checkpoint-every", "2", "--n-rounds", "6"]
    _launch(common + ["--checkpoint-dir", str(tmp_path / "clean"),
                      "--out", str(tmp_path / "clean.npz")])
    obs = tmp_path / "obs"
    obs.mkdir()
    log = _launch(common + ["--checkpoint-dir", str(tmp_path / "killed"),
                            "--out", str(tmp_path / "killed.npz")],
                  REPRO_FAULT_KILL="1:2", REPRO_OBS_DIR=str(obs))
    assert "resilient sweep done" in log
    with np.load(tmp_path / "clean.npz") as a, np.load(tmp_path / "killed.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    events = collections.Counter(
        json.loads(line)["name"]
        for p in obs.glob("*.jsonl") for line in p.read_text().splitlines())
    assert events["resilience.fault_kill"] == 1
    assert events["supervisor.restart"] == 1
    assert events["resilience.resume"] == 1


def test_serve_plan_runs_each_run_on_the_mesh_its_model_field_names(tmp_path):
    """The ``serve`` workload's ``--plan`` runs its runs in one process
    group, each over the mesh its ``model`` field names: qwen2-0.5b at full
    width cut to 1 layer, in fp32, on (2, 1) data-parallel and on (1, 2)
    tensor-parallel over the same two ranks; both layouts' rows decode the
    same tokens as one process, their logits within 1e-5 of its."""
    import torch

    run = tdist.ServeRun(layers=1, dtype="float32", batch=2, prompt=8, steps=2)
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps([dataclasses.asdict(dataclasses.replace(run, model=m))
                                for m in (1, 2)]))
    _launch(["--procs", "2", "--workload", "serve", "--device", "cpu", "--plan", str(plan),
             "--out", str(tmp_path / "serve")])
    ranks = [torch.load(tmp_path / f"serve.rank{r}.pt", weights_only=False) for r in range(2)]
    want = tdist.serve_run(run, "cpu")
    for i, mesh in enumerate(({"data": 2, "model": 1}, {"data": 1, "model": 2})):
        for got in (rank["runs"][i] for rank in ranks):
            assert got["mesh"] == mesh and got["run"]["model"] == mesh["model"]
            assert torch.equal(got["decode"]["whole_tokens"], want["decode"]["whole_tokens"])
            rows = slice(None) if mesh["data"] == 1 else slice(got["coordinates"]["data"],
                                                             got["coordinates"]["data"] + 1)
            err = ((got["prefill"]["logits"] - want["prefill"]["logits"][rows]).norm()
                   / want["prefill"]["logits"][rows].norm()).item()
            assert err <= 1e-5, (mesh, err)


def test_train_plan_runs_and_their_outputs(tmp_path):
    """The ``train`` workload's runs: one from the flags, or a ``--plan``'s
    list of {arch, layers, model, dtype, n_rounds} (a missing key its
    flag's) in one process group; with several runs run i writes ``<stem>.<i><ext>``
    of ``--out`` (and its ranks' blocks beside it)."""
    from types import SimpleNamespace

    flags = dict(arch="qwen2-0.5b", layers=4, model=1, dtype="float32", n_rounds=3)
    assert tdist.train_plan(SimpleNamespace(plan="", **flags)) == [flags]
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps([{"dtype": "float32", "n_rounds": 3},
                                {"arch": "olmoe-1b-7b", "layers": 1, "model": 2,
                                 "dtype": "bfloat16", "n_rounds": 1}]))
    args = SimpleNamespace(plan=str(plan), **{**flags, "dtype": "bfloat16", "n_rounds": 4})
    assert tdist.train_plan(args) == [
        flags, {"arch": "olmoe-1b-7b", "layers": 1, "model": 2, "dtype": "bfloat16",
                "n_rounds": 1}]
    assert tdist.plan_out("/o/train.npz", 0, 1) == "/o/train.npz"
    assert [tdist.plan_out("/o/train.npz", i, 2) for i in range(2)] == ["/o/train.0.npz",
                                                                       "/o/train.1.npz"]
