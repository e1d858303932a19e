"""The port's multi-rank plumbing (``repro_torch.sim.multihost``,
``repro_torch.launch.sharding``, the records npz) held against the
reference's (CPU).

The ``REPRO_DIST_*`` env contract reads as the reference's does (partial
contracts raise, naming what is missing); initialisation is a no-op without
it; a mesh asking for more ranks than the process group holds raises
``ValueError`` naming the launcher; ``shard_to_global`` and
``gather_records`` round-trip a grid over 2 spawned gloo ranks, every rank
getting the whole grid in cell order; ``param_spec`` gives the reference's
specs; a ``LatticeRecords`` goes through ``save_records`` / ``load_records``
bitwise and loads in the reference's ``load_records``. Exact throughout.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist
from _torch_parity import launch_ranks

from repro.launch import distributed as jdist
from repro.launch import sharding as jsharding
from repro.sim import multihost as jmh
from repro_torch.launch import distributed as tdist
from repro_torch.launch import sharding as tsharding
from repro_torch.sim import multihost as tmh
from repro_torch.sim.lattice import LatticeRecords, make_cell_mesh, make_cell_model_mesh

ENV = (tmh.ENV_COORDINATOR, tmh.ENV_NUM_PROCESSES, tmh.ENV_PROCESS_ID)


@pytest.fixture
def one_rank():
    """A one-rank gloo process group for the test, destroyed after it."""
    assert not dist.is_initialized()
    tmh.ensure_process_group(device="cpu")
    yield
    dist.destroy_process_group()


def test_env_contract_matches_the_reference(monkeypatch):
    assert (tmh.ENV_COORDINATOR, tmh.ENV_NUM_PROCESSES, tmh.ENV_PROCESS_ID) == (
        jmh.ENV_COORDINATOR, jmh.ENV_NUM_PROCESSES, jmh.ENV_PROCESS_ID)
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    assert tmh.distributed_env() is None and jmh.distributed_env() is None
    monkeypatch.setenv(tmh.ENV_COORDINATOR, "127.0.0.1:1234")
    for mod in (tmh, jmh):
        with pytest.raises(ValueError, match="REPRO_DIST_NUM_PROCESSES"):
            mod.distributed_env()
    monkeypatch.setenv(tmh.ENV_NUM_PROCESSES, "4")
    monkeypatch.setenv(tmh.ENV_PROCESS_ID, "3")
    got, want = tmh.distributed_env(), jmh.distributed_env()
    assert (got.coordinator, got.num_processes, got.process_id) == (
        want.coordinator, want.num_processes, want.process_id) == ("127.0.0.1:1234", 4, 3)


def test_initialize_distributed_is_a_no_op_without_the_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    assert tmh.initialize_distributed() is False
    assert not dist.is_initialized()


def test_a_single_process_is_a_one_rank_mesh(one_rank):
    assert tmh.initialize_distributed() is True  # idempotent once a group exists
    mesh = make_cell_mesh()
    assert mesh.mesh_dim_names == ("cells",) and tmh.mesh_process_span(mesh) == (0,)
    assert not tmh.mesh_spans_processes(mesh) and not tmh.mesh_spans_processes(None)
    grid = make_cell_model_mesh(1, 1)
    assert grid.mesh_dim_names == ("cells", "model") and tuple(grid.mesh.shape) == (1, 1)
    assert tmh.make_global_cell_model_mesh().mesh_dim_names == ("cells", "model")
    np.testing.assert_array_equal(tmh.shard_to_global(np.arange(5), mesh), np.arange(5))


@pytest.mark.parametrize("make", [lambda: make_cell_mesh(2), lambda: make_cell_model_mesh(1, 2),
                                  lambda: make_cell_model_mesh(2, 1),
                                  lambda: tmh.make_global_cell_mesh(3)])
def test_a_mesh_past_the_process_group_raises_naming_the_launcher(one_rank, make):
    with pytest.raises(ValueError, match="repro_torch.launch.distributed"):
        make()


def test_model_axis_must_be_positive(one_rank):
    with pytest.raises(ValueError, match="model axis must be >= 1"):
        make_cell_model_mesh(1, 0)


def test_shard_and_gather_round_trip_over_two_ranks(tmp_path):
    out = launch_ranks("shard_gather", 2, None, tmp_path)
    grid = np.arange(24, dtype=np.float32).reshape(8, 3)
    np.testing.assert_array_equal(out["blocks"][0], grid[:4])
    np.testing.assert_array_equal(out["blocks"][1], grid[4:])
    *leaves, diag, ev, health = out["gathered"]  # a RoundRecord, its subtrees None
    for k, leaf in enumerate(leaves):
        np.testing.assert_array_equal(leaf, grid + k)
    assert diag is ev is health is None
    assert out["span"] == (0, 1)
    # the reference's padded D at |model| = 2 (its DEFAULT_TILE_D units)
    from repro.kernels.aircomp import DEFAULT_TILE_D

    assert out["n_shards"] == 2
    assert out["padded_dim"] == -(-258_634 // (2 * DEFAULT_TILE_D)) * 2 * DEFAULT_TILE_D
    assert out["padded_dim"] == 259_072
    assert out["leaf_specs"] == [(None, None, None, "model"), (None,), (None, None),
                                 (None, "model")]


class _Mesh:
    """The two attributes ``param_spec`` reads, for both packages' meshes."""

    def __init__(self, names, sizes):
        self.axis_names = self.mesh_dim_names = names
        self.shape = dict(zip(names, sizes))
        self._sizes = sizes

    def size(self, i):
        return self._sizes[i]


@pytest.mark.parametrize("names,sizes", [(("cells", "model"), (4, 2)),
                                         (("cells", "model"), (1, 3)),
                                         (("pod", "data", "model"), (2, 4, 2))])
@pytest.mark.parametrize("shape,skip", [((3, 3, 64, 128), 0), ((784, 10), 0), ((10,), 0),
                                        ((24, 896, 4864), 1), ((4096, 2), 0), ((6, 8), 0)])
def test_param_spec_matches_the_reference(names, sizes, shape, skip):
    mesh = _Mesh(names, sizes)
    want = tuple(jsharding.param_spec(shape, mesh, skip_leading=skip))
    assert tsharding.param_spec(shape, mesh, skip_leading=skip) == want
    assert tsharding.MIN_SHARD_SIZE == jsharding.MIN_SHARD_SIZE


def _records(rng) -> LatticeRecords:
    grid = (2, 3, 1, 1, 2)
    return LatticeRecords(
        axes={"algorithm": ["fedavg", "feddyn"], "policy": ["pofl", "channel", "importance"],
              "noise_power": [1e-10], "alpha": [0.1], "seed": [0, 7]},
        e_com=rng.random(grid + (4,), np.float32), e_var=rng.random(grid + (4,), np.float32),
        grad_norm=rng.random(grid + (4,), np.float32),
        n_scheduled=rng.integers(0, 4, grid + (4,)).astype(np.float32),
        loss=rng.random(grid + (2,), np.float32), acc=rng.random(grid + (2,), np.float32),
        eval_rounds=np.asarray([0, 3], np.int32))


def test_records_npz_round_trip_across_both_packages(tmp_path):
    recs = _records(np.random.default_rng(0))
    path = str(tmp_path / "recs.npz")
    tdist.save_records(path, recs, {"n_rounds": 4, "workload": "parity"})
    back, meta = tdist.load_records(path)
    theirs, their_meta = jdist.load_records(path)
    assert meta == their_meta == {"n_rounds": 4, "workload": "parity"}
    assert back.axes == theirs.axes == recs.axes
    for f in tdist._RECORD_FIELDS + ("eval_rounds",):
        np.testing.assert_array_equal(getattr(back, f), getattr(recs, f))
        np.testing.assert_array_equal(getattr(theirs, f), getattr(recs, f))
    assert tdist._RECORD_FIELDS == jdist._RECORD_FIELDS


def test_backend_is_gloo_on_the_cpu():
    assert tmh.default_backend(2, device="cpu") == "gloo"
    if not torch.cuda.is_available():
        assert tmh.default_backend(1) == "gloo"


LOCAL_ENV = (tmh.ENV_LOCAL_PROCESS_ID, tmh.ENV_LOCAL_NUM_PROCESSES, "LOCAL_RANK",
             "LOCAL_WORLD_SIZE")


@pytest.mark.parametrize("cfg, local", [
    (tmh.DistributedConfig("127.0.0.1:1234", 4, 3), (3, 4)),        # the launcher's host
    (tmh.DistributedConfig("localhost:1234", 2, 1), (1, 2)),
    (tmh.DistributedConfig("[::1]:1234", 2, 0), (0, 2)),
    (tmh.DistributedConfig("10.0.0.5:1234", 1, 0), (0, 1)),         # one rank
    (tmh.DistributedConfig("10.0.0.5:1234", 8, 5, 1, 4), (1, 4)),   # 2 hosts of 4 ranks
])
def test_a_rank_is_placed_on_its_host(cfg, local):
    assert cfg.local() == local


def test_ranks_over_several_hosts_must_say_where_they_run():
    with pytest.raises(ValueError, match="REPRO_DIST_LOCAL_PROCESS_ID.*unverified"):
        tmh.DistributedConfig("10.0.0.5:1234", 8, 5).local()


def test_the_env_gives_the_local_topology(monkeypatch):
    for name in ENV + LOCAL_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(tmh.ENV_COORDINATOR, "10.0.0.5:1234")
    monkeypatch.setenv(tmh.ENV_NUM_PROCESSES, "8")
    monkeypatch.setenv(tmh.ENV_PROCESS_ID, "5")
    with pytest.raises(ValueError, match="several hosts"):
        tmh.distributed_env().local()
    monkeypatch.setenv("LOCAL_RANK", "1")          # torchrun's pair
    with pytest.raises(ValueError, match="partial local topology"):
        tmh.distributed_env()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert tmh.distributed_env().local() == (1, 4)
    monkeypatch.setenv(tmh.ENV_LOCAL_PROCESS_ID, "2")  # the contract's own pair first
    monkeypatch.setenv(tmh.ENV_LOCAL_NUM_PROCESSES, "4")
    assert tmh.distributed_env().local() == (2, 4)


def test_backend_counts_the_ranks_of_this_host_against_its_cards(monkeypatch):
    """NCCL when this host's ranks each have a card, whatever the global
    count; gloo when they share one or compute on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    two_hosts = tmh.DistributedConfig("10.0.0.5:1234", 8, 5, 1, 4)
    assert tmh.default_backend(two_hosts.local()[1]) == "nccl"
    assert tmh.default_backend(tmh.DistributedConfig("127.0.0.1:1", 8, 5).local()[1]) == "gloo"
    assert tmh.default_backend(4, device="cpu") == "gloo"
