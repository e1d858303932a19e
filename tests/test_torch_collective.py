"""The port's noisy all-reduce (``repro_torch.core.collective``) held
against the reference (CPU).

Over 4 spawned gloo ranks, rank i holding device i's gradient,
``aircomp_allreduce`` gives the reference's single-host Eq. 16 aggregate
(``aircomp.aircomp_aggregate(..., simulate_physical=False)``) on the same
receiver noise z (drawn in JAX from the reference's noise key) on every
rank; on a one-rank mesh in this process ``make_sharded_aggregator`` gives
the reference's ``make_sharded_aggregator`` on a one-device mesh, its noise
the reference's key split. Tolerance: 1e-5 relative to the reference's
scale (the sum order differs).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from _torch_parity import assert_close, launch_ranks, t
from torch.distributed.device_mesh import DeviceMesh

from repro.core import aircomp as jair
from repro.core import collective as jcollective
from repro.core.numerics import eps_guard
from repro_torch.core import collective as tcollective
from repro_torch.sim import multihost as tmh


def _round(n: int, dim: int, noise_power: float):
    """A round's gradients, channel, weights and schedule, drawn in JAX, and
    the reference's Eq. 16 aggregate with its noise key."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    g = jax.random.normal(k1, (n, dim))
    h = ((jax.random.normal(k2, (n,)) + 1j * jax.random.normal(k3, (n,))) / jnp.sqrt(2))
    rho = jnp.linspace(0.05, 0.2, n)
    mask = (jnp.arange(n) % 2 == 0).astype(jnp.float32)
    noise_key = jax.random.PRNGKey(5)
    y_ref, _ = jair.aircomp_aggregate(g, rho, h.astype(jnp.complex64), mask, noise_key, 1.0,
                                      noise_power, simulate_physical=False)
    _, v_g = jair.global_stats(jair.local_stats(g), rho, mask)
    a = jair.denoise_scalar(rho, jnp.abs(h), mask, 1.0)
    return dict(g=g, coeffs=mask * rho, noise_amp=jnp.sqrt(eps_guard(v_g)) / a,
                noise_key=noise_key, y_ref=y_ref)


@pytest.mark.parametrize("noise_power", [0.0, 1e-4])
def test_allreduce_over_four_ranks_matches_the_eq16_aggregate(tmp_path, noise_power):
    r = _round(4, 64, noise_power)
    z = jax.random.normal(r["noise_key"], (64,))  # aircomp_aggregate's draw
    inp = {"g": t(r["g"]), "coeffs": t(r["coeffs"]),
           "noise_amp": t(r["noise_amp"] * jnp.sqrt(noise_power)), "z": t(z)}
    out = launch_ranks("allreduce", 4, inp, tmp_path)
    assert_close(out["y"], r["y_ref"])


def test_sharded_aggregator_on_one_rank_matches_the_reference():
    assert not dist.is_initialized()
    tmh.ensure_process_group(device="cpu")
    try:
        r = _round(1, 96, 1e-4)
        key = jax.random.PRNGKey(11)
        jmesh = jax.make_mesh((1,), ("data",))
        want = jcollective.make_sharded_aggregator(jmesh, "data")(
            r["g"], r["coeffs"], r["noise_amp"], key)
        # the reference's noise: its one leaf's key of split(key, 1)
        z = jax.random.normal(jax.random.split(key, 1)[0], (96,))
        mesh = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("data",))
        agg = tcollective.make_sharded_aggregator(mesh, "data")
        got = agg(t(r["g"]), t(r["coeffs"]), t(r["noise_amp"]), t(z))
        assert_close(got, want)
        with pytest.raises(ValueError, match="1 ranks"):
            agg(torch.zeros(2, 96), torch.zeros(2), 0.0, torch.zeros(96))
    finally:
        dist.destroy_process_group()


def test_allreduce_on_one_rank_weights_and_adds_the_noise():
    """The reference's single-device semantics test: one rank, the sum is
    the rank's own weighted leaf, each leaf with its own noise."""
    assert not dist.is_initialized()
    tmh.ensure_process_group(device="cpu")
    try:
        g = {"w": torch.arange(8.0), "b": torch.ones(3)}
        z = {"w": torch.ones(8), "b": torch.full((3,), 2.0)}
        out = tcollective.aircomp_allreduce(g, torch.tensor(2.0), torch.tensor(0.5), z)
        want = jcollective.aircomp_allreduce(
            {"w": jnp.arange(8.0), "b": jnp.ones(3)}, jnp.asarray(2.0), jnp.asarray(0.0),
            jax.random.PRNGKey(0), ())
        np.testing.assert_array_equal(out["w"].numpy(), np.asarray(want["w"]) + 0.5)
        np.testing.assert_array_equal(out["b"].numpy(), np.asarray(want["b"]) + 1.0)
    finally:
        dist.destroy_process_group()
