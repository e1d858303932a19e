"""PO-FL trainer: Algorithm 1 at model scale, on one card or over ranks.

Port of ``repro.launch.train``. Each FL device is a slice of the global
batch (:mod:`repro_torch.launch.mesh`): on one card (``HostMesh``) every
slice is computed in one process; on a ``RankMesh`` each data rank
computes its FL devices' slices and holds its blocks of the fp32 masters
and the optimizer state by their specs, and over M > 1 model ranks a dense
or SSM model's products are split tensor-parallel (:mod:`repro_torch.launch.steps`:
the steps decide the layout from the mesh and the family).
A round:

  1. per-FL-device gradient stats (M_i, V_i, ‖g_i‖), ``stats_mode``:
       "sketch": JVP-sketched (:mod:`repro_torch.core.sketch`), k + 1
                 forward-mode passes
       "loss":   the reference's proxy: stats that stay ones, as the
                 reference never refreshes them (kept; ROADMAP C)
  2. the channel draw h_i^t (Rayleigh fading, :mod:`repro_torch.core.channel`)
  3. the schedule: probabilities p_i^t (policy-selectable), a draw without
     replacement, aggregation coefficients c_i = mask_i · ρ_i
  4. the train step: the weighted backward (= the AirComp superposition),
     Eq. 16 receiver noise and the optimizer's update
     (:mod:`repro_torch.launch.steps`)

Every random value of a round comes from one draws object
(:class:`TrainerDraws`): the sketch's probes, the channel h, the sampler's
Gumbel vectors and the noise leaves, all whole-shaped. By default it draws
them from the trainer's own ``torch.Generator``; a test hands in one that
replays another stream. Over ranks every rank draws the same values from
the same seed, and the schedule (coeffs, ν, e_com, a, |S|) is broadcast
from rank 0, so no two ranks can take different decisions. The round's
steps run in ``torch.profiler.record_function`` ranges ``train.stats``,
``train.schedule`` and ``train.step``.

    python -m repro_torch.launch.train --rounds 30

runs what the reference's ``examples/train_pofl_lm.py`` runs, with its
flags and defaults (and ``--fl-devices``, the FL device count the
reference takes from its host's device count, and ``--device``). Under the
launcher's env contract (``REPRO_DIST_*``, or torchrun's) it trains over
the process group's ranks, ``--model`` ranks a model group:

    python -m repro_torch.launch.distributed --procs 2 -- \\
        python -m repro_torch.launch.train --device cpu --rounds 4 --model 1
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import aircomp, scheduling
from repro_torch.core.channel import ChannelConfig, ChannelState
from repro_torch.core.sketch import draw_probes
from repro_torch.launch.mesh import RankMesh, batch_ways, wire_bytes
from repro_torch.launch.steps import block_of, build_stats_step, build_train_step, params_structs
from repro_torch.models import api
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.optim.optimizers import Optimizer, adamw

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    policy: str = "pofl"
    alpha: float = 0.1
    n_scheduled: int = 10
    tx_power: float = 1.0
    noise_power: float = 1e-11
    stats_mode: str = "sketch"   # sketch | loss
    n_probes: int = 4
    dtype: str = "bfloat16"
    seed: int = 0
    log_every: int = 10


class TrainerDraws:
    """A round's random values, drawn from ``generator`` in the order the
    round asks for them."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def probes(self, params, n_probes: int) -> list:
        """The sketch's Hutchinson probes: param-shaped standard normals."""
        return draw_probes(params, n_probes, self.generator)

    def channel(self, channel: ChannelState) -> torch.Tensor:
        """This round's fading h (complex64, (n_fl,))."""
        return channel.sample(self.generator)

    def gumbels(self, n_scheduled: int, n: int) -> torch.Tensor:
        """The sequential sampler's Gumbel vectors, (n_scheduled, n)."""
        return scheduling.gumbel((n_scheduled, n), self.generator)

    def noise(self, params) -> dict:
        """Eq. 16's z: param-shaped standard normals, drawn leaf by leaf in
        sorted-key order."""
        return draw_probes(params, 1, self.generator)[0]


def _agree(mesh: RankMesh, values: list) -> list:
    """``values`` (tensors on the mesh's device) as rank 0 has them: one
    float64 broadcast, each value back in its own dtype and shape."""
    import torch.distributed as dist

    flat = torch.cat([v.reshape(-1).to(torch.float64) for v in values])
    with mesh.collective("broadcast", wire_bytes("broadcast", flat.numel() * 8, mesh.n_ranks)):
        dist.broadcast(flat, src=0)
    parts = torch.split(flat, [v.numel() for v in values])
    return [p.reshape(v.shape).to(v.dtype) for p, v in zip(parts, values)]


class POFLTrainer:
    """Stateful trainer wiring the schedule, the channel and the steps."""

    def __init__(
        self,
        cfg: ModelConfig,
        shape: InputShape,
        mesh,
        tcfg: TrainerConfig = TrainerConfig(),
        optimizer: Optional[Optimizer] = None,
        draws: Optional[TrainerDraws] = None,
    ):
        self.cfg, self.shape, self.mesh, self.tcfg = cfg, shape, mesh, tcfg
        self.device = mesh.device
        self.n_fl = batch_ways(mesh)
        self.n_sched = min(tcfg.n_scheduled, self.n_fl)
        dtype = DTYPES[tcfg.dtype]
        self.optimizer = optimizer or adamw(1e-4)
        self.train_bundle = build_train_step(
            cfg, shape, mesh, self.optimizer, dtype=dtype,
            aircomp_noise=tcfg.policy != "noisefree",
        )
        self.stats_bundle = (
            build_stats_step(cfg, shape, mesh, dtype=dtype, n_probes=tcfg.n_probes)
            if tcfg.stats_mode == "sketch" else None
        )
        self.generator = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        self.draws = draws or TrainerDraws(self.generator)
        self.channel = ChannelState.create(
            ChannelConfig(n_devices=self.n_fl, tx_power=tcfg.tx_power,
                          noise_power=tcfg.noise_power),
            self.generator,
        )
        self.data_frac = torch.full((self.n_fl,), 1.0 / self.n_fl, device=self.device)
        # over ranks the draws are whole-shaped (every rank the same) and
        # the steps take this rank's blocks
        self.ranks = isinstance(mesh, RankMesh)
        self.whole = params_structs(cfg) if self.ranks else None
        # the reference's count, which leaves out the QKV bias and the final
        # norm (ROADMAP C): Eq. 34/35 read it
        self.dim = self.cfg.param_count()
        self._loss_stats = None  # "loss" mode's stats: never refreshed, as in the reference

    def init_state(self, seed: int, dt_init: str = "zeros"):
        """Fresh fp32 parameters from ``seed`` (``dt_init``: a Mamba2
        layer's dt_bias, ``api.model_init``) and their optimizer state
        (over ranks: this rank's blocks of both)."""
        params = api.model_init(self.cfg, seed, device=self.device, dt_init=dt_init)
        if self.ranks:
            params = block_of(params, self.train_bundle.in_shardings["params"])
        return params, self.optimizer.init(params)

    def _shapes(self, params):
        """What the draws are shaped like: the whole parameters."""
        return self.whole if self.ranks else params

    def _round_stats(self, params, batch):
        t = self.tcfg
        if t.stats_mode == "sketch":
            probes = self.draws.probes(self._shapes(params), t.n_probes)
            mean, var, norm = self.stats_bundle.fn(params, batch, probes)
            return aircomp.GradStats(mean=mean, var=var, norm=norm)
        per_dev = self._loss_stats
        if per_dev is None:
            ones = torch.ones((self.n_fl,), device=self.device)
            per_dev = aircomp.GradStats(mean=0.0 * ones, var=ones, norm=ones)
        return per_dev

    def schedule_round(self, stats):
        """Steps 2–3 of the round: channel, probabilities, schedule, coeffs
        → (coeffs (n_fl,), noise_amp, {"e_com", "a", "n_scheduled"})."""
        t = self.tcfg
        h_abs = self.draws.channel(self.channel).abs()
        probs = scheduling.scheduling_probs(
            t.policy, stats.norm, stats.var, h_abs, self.data_frac, self.dim,
            t.alpha, t.tx_power, t.noise_power,
        )
        sched = scheduling.sample_without_replacement(
            self.draws.gumbels(self.n_sched, self.n_fl), probs, self.n_sched)
        rho = scheduling.aggregation_weights(sched, probs, self.data_frac, self.n_sched)
        _, v_g = aircomp.global_stats(stats, rho, sched.mask)
        a = aircomp.denoise_scalar(rho, h_abs, sched.mask, t.tx_power)
        if t.policy == "noisefree":
            noise_amp = torch.zeros((), device=self.device)
        else:
            noise_amp = torch.sqrt(torch.clamp_min(v_g, 0.0)) / a * math.sqrt(t.noise_power)
        e_com = aircomp.distortion_closed_form(
            v_g, rho, h_abs, sched.mask, self.dim, t.tx_power, t.noise_power)
        coeffs = (rho * sched.mask).float()
        out = [coeffs, noise_amp.float(), e_com, a, sched.mask.sum()]
        if self.ranks:
            out = _agree(self.mesh, out)
        coeffs, noise_amp, e_com, a, n_scheduled = out
        return coeffs, noise_amp, {"e_com": e_com, "a": a, "n_scheduled": n_scheduled}

    def train_round(self, params, opt_state, batch):
        """One round on the global ``batch`` (over ranks every rank passes
        the same batch and its own blocks of params and opt_state) →
        ``(params, opt_state, diag)``: diag holds the schedule's ``e_com``,
        ``a``, ``n_scheduled``, ``coeffs`` and ``noise_amp``, the
        statistics it was made from (``grad_mean``, ``grad_var``,
        ``grad_norm``, each (n_fl,)), and the weighted ``loss``."""
        if self.ranks:
            batch = block_of(batch, self.train_bundle.in_shardings["batch"])
        with record_function("train.stats"):
            stats = self._round_stats(params, batch)
        with record_function("train.schedule"):
            coeffs, noise_amp, diag = self.schedule_round(stats)
        with record_function("train.step"):
            noise = self.draws.noise(self._shapes(params))
            if self.ranks:
                noise = block_of(noise, self.train_bundle.in_shardings["noise"])
            params, opt_state, loss = self.train_bundle.fn(
                params, opt_state, batch, coeffs, noise_amp, noise)
        diag.update(loss=loss, coeffs=coeffs, noise_amp=noise_amp, grad_mean=stats.mean,
                    grad_var=stats.var, grad_norm=stats.norm)
        return params, opt_state, diag


def run_training(
    trainer: POFLTrainer,
    batch_fn: Callable[[int], dict],
    n_rounds: int,
    log: bool = True,
):
    """Simple training loop: ``batch_fn(t)`` yields the round-t global batch."""
    params, opt_state = trainer.init_state(trainer.tcfg.seed + 1)
    losses = []
    t0 = time.time()
    for t in range(n_rounds):
        batch = batch_fn(t)
        params, opt_state, diag = trainer.train_round(params, opt_state, batch)
        losses.append(float(diag["loss"]))
        if log and (t % trainer.tcfg.log_every == 0 or t == n_rounds - 1):
            print(
                f"[train] round {t:4d}  loss {losses[-1]:.4f}"
                f"  e_com {float(diag['e_com']):.3e}"
                f"  ({time.time()-t0:.1f}s)",
                flush=True,
            )
    return params, opt_state, np.asarray(losses)


def _join_ranks(device=None) -> bool:
    """Join the process group the env names: the launcher's
    (``REPRO_DIST_*``, :func:`repro_torch.sim.multihost.initialize_distributed`)
    or torchrun's (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``; its agent hosts the rendezvous store at
    ``MASTER_ADDR:MASTER_PORT``). False when neither is set."""
    import datetime
    import os

    import torch.distributed as dist

    from repro_torch.sim.multihost import INIT_TIMEOUT, default_backend, initialize_distributed

    if initialize_distributed(device=device):
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    local = int(os.environ.get("LOCAL_RANK", 0))
    cpu = device is not None and torch.device(device).type == "cpu"
    if torch.cuda.is_available() and not cpu:
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(default_backend(int(os.environ.get("LOCAL_WORLD_SIZE", 1)), device),
                            init_method="env://",
                            timeout=datetime.timedelta(seconds=INIT_TIMEOUT))
    return True


def main(argv=None):
    """PO-FL training of a scaled-down LM on ``--fl-devices`` FL devices:
    ``examples/train_pofl_lm.py`` of the reference, on the card by default;
    over the ranks of a process group when the env names one (rank 0 logs)."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data.synthetic import make_token_dataset
    from repro_torch.launch.mesh import make_host_mesh, make_rank_mesh
    from repro_torch.optim.optimizers import cosine_schedule

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--dmodel", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--policy", default="pofl")
    ap.add_argument("--arch", default="qwen2-0.5b", help="architecture family to scale down")
    ap.add_argument("--fl-devices", type=int, default=8,
                    help="FL devices (slices of the batch)")
    ap.add_argument("--model", type=int, default=1,
                    help="over ranks: the ranks of a model group (the rest are data ranks)")
    ap.add_argument("--device", default=None, help="the card unless given (e.g. cpu)")
    args = ap.parse_args(argv)

    cfg = configs.base_config(args.arch)
    cfg = dataclasses.replace(
        cfg, n_layers=args.layers, d_model=args.dmodel,
        n_heads=max(4, args.dmodel // 64), n_kv_heads=max(2, args.dmodel // 128),
        d_ff=args.dmodel * 4, vocab_size=4096, tie_embeddings=True,
    )
    ranks = _join_ranks(args.device)
    if ranks:
        mesh = make_rank_mesh(model=args.model, n_fl=args.fl_devices, device=args.device)
    else:
        mesh = make_host_mesh(model=1, n_devices=args.fl_devices, device=args.device)
    lead = not ranks or dist.get_rank() == 0
    n_fl = batch_ways(mesh)
    if lead:
        print(f"model: {cfg.name} family, {cfg.param_count()/1e6:.1f}M params")
        print(f"mesh: {mesh.shape}  ({n_fl} FL devices on {mesh.device}"
              f"{f', {mesh.n_ranks} ranks' if ranks else ''})")

    shape = InputShape("lm", seq_len=args.seq, global_batch=args.batch, kind="train")
    trainer = POFLTrainer(
        cfg, shape, mesh,
        TrainerConfig(policy=args.policy, n_scheduled=max(1, n_fl // 2),
                      noise_power=1e-10, stats_mode="sketch", n_probes=2),
        optimizer=adamw(cosine_schedule(3e-4, args.rounds, warmup=10)),
    )

    gen = torch.Generator(device=mesh.device).manual_seed(0)
    tokens = make_token_dataset(args.batch * 8, args.seq, cfg.vocab_size, gen)

    def batch_fn(t):
        idx = torch.arange(args.batch, device=mesh.device) + (t * args.batch) % (args.batch * 7)
        return {"tokens": tokens[idx]}

    _, _, losses = run_training(trainer, batch_fn, args.rounds, log=lead)
    if lead:
        print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    if ranks:
        dist.destroy_process_group()
    if not losses[-1] < losses[0]:
        raise SystemExit("training did not descend")


if __name__ == "__main__":
    main()
