"""Channel processes and data partitions (port of ``repro.sim.scenario``).

A channel process is a frozen dataclass with the interface

    proc.init(generator)   -> state                 (a tuple of tensors)
    proc.draw(generator)   -> prims                 (one step's random inputs)
    proc.step(state, prims) -> (state', h, avail)

``h`` is the complex64 (N,) fading of the round and ``avail`` a float 0/1
(N,) availability mask. :meth:`step` computes from its random primitives
as tensors (standard normals, uniforms), so a test can feed it the
reference's draws; :meth:`draw` makes them from a ``torch.Generator`` in
normal use. The state is the reference's state tuple, element for element.
Processes with ``can_drop = False`` give all-ones availability, and the
engine then skips the scheduling mask as the reference does. A Bernoulli
draw ``jax.random.bernoulli(k, p)`` is ``uniform < p`` here too.

Channel scenarios (``make_channel_process(name, cfg, **params)``):
``static_rayleigh`` (the paper's Sec. V-A block fading), ``gauss_markov``
(h_t = ρ h_{t-1} + sqrt(1-ρ²) CN(0, g), parameter ``corr``), ``mobility``
(a reflected Gaussian random walk of the distances, ``speed``), ``dropout``
(each device unavailable with probability ``p_drop`` each round, over a
``base`` process) and ``churn`` (a two-state Markov chain of presence,
``p_depart``/``p_arrive``/``init_online``, over a ``base`` process).
Availability gates scheduling only; the base process evolves underneath.

Partitions (``make_partition``): ``iid``, ``shards``, ``dirichlet``,
``dirichlet_sized`` and ``dirichlet_mixed`` (``repro_torch.data.partition``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core.channel import (
    ChannelConfig, device_distances, path_loss, sample_channels,
)
from repro_torch.data.partition import (
    partition_dirichlet,
    partition_dirichlet_mixed,
    partition_dirichlet_sized,
    partition_iid,
    partition_noniid_shards,
)


def _normals(cfg: ChannelConfig, generator: torch.Generator, k: int) -> tuple:
    n, dev = cfg.n_devices, generator.device
    return tuple(torch.randn(n, generator=generator, device=dev) for _ in range(k))


def _uniform(cfg: ChannelConfig, generator: torch.Generator) -> torch.Tensor:
    return torch.rand(cfg.n_devices, generator=generator, device=generator.device)


def _gains(cfg: ChannelConfig, generator: torch.Generator) -> torch.Tensor:
    """Path-loss gains of distances drawn uniform in [d_min, d_max]."""
    return path_loss(cfg, device_distances(cfg, _uniform(cfg, generator)))


@dataclasses.dataclass(frozen=True)
class StaticRayleigh:
    """Paper Sec. V-A: static path loss, i.i.d. Rayleigh block fading.
    State ``(gains,)``; a step's primitives are the fading's (re, im)."""

    cfg: ChannelConfig
    can_drop = False

    def init(self, generator: torch.Generator):
        return (_gains(self.cfg, generator),)

    def draw(self, generator: torch.Generator):
        return _normals(self.cfg, generator, 2)

    def step(self, state, prims):
        (gains,) = state
        h = sample_channels(gains, *prims)
        return state, h, torch.ones_like(gains)


@dataclasses.dataclass(frozen=True)
class GaussMarkov:
    """First-order Gauss–Markov fading: h_t = ρ h_{t-1} + sqrt(1-ρ²) CN(0, g).
    State ``(gains, h)`` from a stationary start; primitives: the
    innovation's (re, im)."""

    cfg: ChannelConfig
    corr: float = 0.9  # ρ — per-round temporal correlation
    can_drop = False

    def init(self, generator: torch.Generator):
        gains = _gains(self.cfg, generator)
        return (gains, sample_channels(gains, *_normals(self.cfg, generator, 2)))

    def draw(self, generator: torch.Generator):
        return _normals(self.cfg, generator, 2)

    def step(self, state, prims):
        gains, h_prev = state
        innov = sample_channels(gains, *prims)
        h = self.corr * h_prev + math.sqrt(1.0 - self.corr**2) * innov
        return (gains, h), h, torch.ones_like(gains)


@dataclasses.dataclass(frozen=True)
class Mobility:
    """Time-varying path loss from a per-round Gaussian random walk of the
    distances, reflected into [d_min, d_max]. State ``(distances,)``;
    primitives: the walk's normals, then the fading's (re, im)."""

    cfg: ChannelConfig
    speed: float = 1.0  # distance random-walk std [m/round]
    can_drop = False

    def init(self, generator: torch.Generator):
        return (device_distances(self.cfg, _uniform(self.cfg, generator)),)

    def draw(self, generator: torch.Generator):
        return _normals(self.cfg, generator, 3)

    def step(self, state, prims):
        (dist,) = state
        walk, re, im = prims
        dist = dist + self.speed * walk
        lo, hi = self.cfg.d_min, self.cfg.d_max
        span = hi - lo
        # jnp.mod takes the divisor's sign: torch.remainder, not torch.fmod
        dist = lo + torch.abs(torch.remainder(dist - lo, 2.0 * span) - span)
        h = sample_channels(path_loss(self.cfg, dist), re, im)
        return (dist,), h, torch.ones_like(dist)


@dataclasses.dataclass(frozen=True)
class Dropout:
    """Each device independently unavailable with probability ``p_drop``
    each round, over a base process that keeps evolving underneath.
    Primitives: the base's, then (N,) uniforms (down where ``u < p_drop``)."""

    base: Any  # any channel process
    p_drop: float = 0.1
    can_drop = True

    def init(self, generator: torch.Generator):
        return self.base.init(generator)

    def draw(self, generator: torch.Generator):
        return (self.base.draw(generator), _uniform(self.base.cfg, generator))

    def step(self, state, prims):
        base_prims, u = prims
        state, h, avail = self.base.step(state, base_prims)
        return state, h, avail * (1.0 - (u < self.p_drop).to(torch.float32))


@dataclasses.dataclass(frozen=True)
class Churn:
    """Arrival/departure churn: presence is a per-device two-state Markov
    chain (online devices depart with probability ``p_depart``, offline ones
    arrive with ``p_arrive``) over a base process. Stationary online share
    ``p_arrive/(p_arrive+p_depart)``, lag-1 autocorrelation
    ``1 - p_arrive - p_depart``. State ``(base state, online)``; the
    initial presence is ``u < init_online`` (the stationary share by
    default); a step's primitives: the base's, then (N,) uniforms ``u``
    (an online device stays where ``u ≥ p_depart``, an offline one arrives
    where ``u < p_arrive``)."""

    cfg: ChannelConfig
    base: Any  # any channel process
    p_depart: float = 0.05
    p_arrive: float = 0.2
    init_online: float | None = None  # initial P(online); default stationary
    can_drop = True

    @property
    def _p0(self) -> float:
        if self.init_online is not None:
            return self.init_online
        return self.p_arrive / max(self.p_arrive + self.p_depart, 1e-12)

    def init(self, generator: torch.Generator):
        base_state = self.base.init(generator)
        online0 = (_uniform(self.cfg, generator) < self._p0).to(torch.float32)
        return (base_state, online0)

    def draw(self, generator: torch.Generator):
        return (self.base.draw(generator), _uniform(self.cfg, generator))

    def step(self, state, prims):
        base_state, online = state
        base_prims, u = prims
        base_state, h, base_avail = self.base.step(base_state, base_prims)
        stay = online * (u >= self.p_depart).to(torch.float32)
        arrive = (1.0 - online) * (u < self.p_arrive).to(torch.float32)
        online = stay + arrive
        return (base_state, online), h, base_avail * online


CHANNEL_SCENARIOS = ("static_rayleigh", "gauss_markov", "mobility", "dropout", "churn")


def make_channel_process(name: str, cfg: ChannelConfig, **params):
    """Instantiate a registered channel process over ``cfg``.

    ``dropout`` and ``churn`` take ``base="..."`` plus the base scenario's
    params, e.g. ``make_channel_process("dropout", cfg, p_drop=0.2,
    base="gauss_markov", corr=0.95)``.
    """
    params = dict(params)
    if name == "static_rayleigh":
        return StaticRayleigh(cfg, **params)
    if name == "gauss_markov":
        return GaussMarkov(cfg, **params)
    if name == "mobility":
        return Mobility(cfg, **params)
    if name == "dropout":
        base_name = params.pop("base", "static_rayleigh")
        p_drop = params.pop("p_drop", 0.1)
        return Dropout(base=make_channel_process(base_name, cfg, **params), p_drop=p_drop)
    if name == "churn":
        base_name = params.pop("base", "static_rayleigh")
        churn_kw = {k: params.pop(k) for k in ("p_depart", "p_arrive", "init_online")
                    if k in params}
        return Churn(cfg=cfg, base=make_channel_process(base_name, cfg, **params),
                     **churn_kw)
    raise ValueError(f"unknown channel scenario {name!r}; known: {CHANNEL_SCENARIOS}")


PARTITIONS = ("iid", "shards", "dirichlet", "dirichlet_sized", "dirichlet_mixed")


def make_partition(name: str, features, labels, n_devices: int, seed: int = 0, **kw):
    """Partition (features, labels) into stacked per-device shards (along
    axis 0 only, so flat and image-shaped features both work)."""
    if name == "iid":
        return partition_iid(features, labels, n_devices, seed=seed)
    if name == "shards":
        return partition_noniid_shards(features, labels, n_devices, seed=seed, **kw)
    if name == "dirichlet":
        return partition_dirichlet(features, labels, n_devices, seed=seed, **kw)
    if name == "dirichlet_sized":
        return partition_dirichlet_sized(features, labels, n_devices, seed=seed, **kw)
    if name == "dirichlet_mixed":
        return partition_dirichlet_mixed(features, labels, n_devices, seed=seed, **kw)
    raise ValueError(f"unknown partition {name!r}; known: {PARTITIONS}")
