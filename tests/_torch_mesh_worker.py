"""One rank of the port's multi-rank CPU tests (no JAX here).

    python -m repro_torch.launch.distributed --procs N -- \\
        python tests/_torch_mesh_worker.py <job> <input> <output>

Each rank joins the process group from the ``REPRO_DIST_*`` env contract
(gloo), runs ``<job>`` and rank 0 writes what the test compares to
``<output>`` (``torch.save``); every rank checks that it got what rank 0
got. Jobs:

  shard_gather  ``shard_to_global`` and ``gather_records`` over a cells
                mesh of every rank: the blocks tile the grid, the gather
                gives every rank the whole grid in cell order.
  allreduce     ``aircomp_allreduce`` of rank i's row of the input's g,
                with its coefficient and the shared z (the input's).
  cnn_parity    the launcher's full-width CNN parity check
                (``launch.distributed._cnn_parity``) on a narrow CNN (4
                devices), over a cells mesh of every rank and a (1, N) model
                mesh: each round from the unsharded state, and whether the
                sharded calls were timed, with their launch counts (their
                times differ by rank, so not returned).
  lattice       the input's lattice cases (``tests/test_torch_lattice_mesh.py``),
                each ``run_lattice`` with its keywords on the mesh it names,
                its draws replayed per seed from the input (the reference's,
                drawn in the test process).
  train_ranks   the input's trainer cases (``tests/test_torch_train_ranks.py``):
                each ``POFLTrainer`` on a (data, model) mesh of every rank
                from the input's whole parameters, its rounds' draws
                replayed (:class:`ReplayDraws`) and its channel gains the
                input's: every round's diag, and every rank's blocks of
                the final parameters, of the optimizer state and of the
                gradients that reached the optimizer, the shapes of the
                weights each ``model_loss`` call of its steps got (its
                compute blocks: TP blocks where its model group splits a
                dense model), its compute-weight bytes and its
                collectives (calls and wire bytes), gathered by rank.
  tp_route      on the card (gloo ranks sharing it): one bf16 train step of
                the input's dense model (its weights drawn on the card from
                the input's seed) split over a (1, 2) mesh of every rank,
                its row-split partials by ``mm``'s fp32 accumulator (the
                card's route) and again by fp32 copies of the same bf16
                values (the CPU's route): each rank's gradient blocks by
                route and how many partials took the card's.
  serve_ranks   the input's serving cases (``tests/test_torch_serve_ranks.py``):
                each a ``Server`` on a (data, model) mesh of every rank, in
                fp32, its weights whole or this rank's blocks of them,
                prefilling its rows of the input's prompt and decoding
                greedily: every rank's served weights (its TP blocks),
                first tokens, logits (gathered whole) and cache blocks of
                the prefill, its decoded tokens, each step's logits and its
                final blocks, the whole batch's tokens gathered, and its
                collectives (calls and wire bytes) of loading and
                prefilling and of decoding, gathered by rank; besides, the
                serving steps' own functions on this rank's TP blocks: the
                prefill step's logits (its vocabulary block) and cache
                blocks, the cache gathered whole from them and cut again,
                and one decode step's token from the prefilled blocks.
  moe_ranks     the input's MoE cases (``tests/test_torch_moe.py``) over a
                (data, 1) mesh of every rank, on the input's device (gloo
                ranks sharing a card there): each ``layer`` case's
                ``moe_fwd`` of this rank's rows of x over the data group
                (its weights the input's, or drawn on the device from its
                seed),
                its output, aux, route and the aux's gradient (router and
                rows); each ``micro`` case's weighted loss and gradients
                over its microbatches (``launch.steps._weighted_grads``)
                on this rank's FL devices' rows, and its routes; gathered
                by rank.
"""
from __future__ import annotations

import sys
import types

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)


def replay(draws: dict) -> None:
    """``SimEngine``'s per-seed draw streams become ``draws[seed][round]``
    (a stream is the tensor [seed, round], as ``tests/_torch_parity.py``
    replays them)."""
    from repro_torch.sim import engine

    def start(self, seed):
        return engine.DrawStream(rng=torch.tensor([seed, 0]), chan=())

    def advance(self, stream, dim):
        seed, rnd = (int(x) for x in stream.rng)
        return (engine.DrawStream(rng=torch.tensor([seed, rnd + 1]), chan=()),
                engine.RoundDraws(*draws[seed][rnd]))

    engine.SimEngine.draw_stream = start
    engine.SimEngine.next_draws = advance


class ReplayDraws:
    """A trainer's draws handed in: ``rounds[t]`` holds round t's
    ``probes``, ``h``, ``gumbels`` and ``noise``, taken in the order a round
    asks for them (the noise last)."""

    def __init__(self, rounds: list):
        self.rounds, self.t = rounds, 0

    def probes(self, params, n_probes):
        return self.rounds[self.t]["probes"]

    def channel(self, channel):
        return self.rounds[self.t]["h"]

    def gumbels(self, n_scheduled, n):
        return self.rounds[self.t]["gumbels"]

    def noise(self, params):
        self.t += 1
        return self.rounds[self.t - 1]["noise"]


def recording(optimizer, seen: list):
    """``optimizer`` whose update first appends the gradients it gets."""
    from repro_torch.optim.optimizers import Optimizer

    def update(grads, state, params):
        seen.append(grads)
        return optimizer.update(grads, state, params)

    return Optimizer(optimizer.init, update)


def shard_gather(_inp) -> dict:
    from repro_torch.core.pofl import ModelShard
    from repro_torch.sim.engine import RoundRecord
    from repro_torch.sim.lattice import make_cell_mesh, make_cell_model_mesh
    from repro_torch.sim.multihost import gather_records, mesh_process_span, shard_to_global

    mesh = make_cell_mesh()
    world = dist.get_world_size()
    grid = np.arange(4 * world * 3, dtype=np.float32).reshape(4 * world, 3)
    block = shard_to_global(grid, mesh)
    blocks = [None] * world
    dist.all_gather_object(blocks, block)
    gathered = gather_records(RoundRecord(*(block + k for k in range(6))), mesh)
    ms = ModelShard(make_cell_model_mesh(1, world))
    return {"blocks": blocks, "gathered": list(gathered), "span": mesh_process_span(mesh),
            "padded_dim": ms.padded_dim(258_634), "n_shards": ms.n_shards,
            "leaf_specs": [ms.leaf_sharding(s)
                           for s in ((3, 3, 32, 64), (10,), (128, 10), (784, 10))]}


def allreduce(inp) -> dict:
    from repro_torch.core.collective import aircomp_allreduce

    r = dist.get_rank()
    out = aircomp_allreduce({"g": inp["g"][r]}, inp["coeffs"][r], inp["noise_amp"],
                            {"g": inp["z"]})
    return {"y": out["g"]}


def cnn_parity(_inp) -> dict:
    from repro_torch.core.pofl import POFLConfig
    from repro_torch.launch import distributed
    from repro_torch.sim.lattice import LatticeSpec, make_cell_mesh, make_cell_model_mesh
    from repro_torch.sim.tasks import make_model_task

    def narrow(device, n_rounds):
        task = make_model_task("cnn", n_devices=4, n_train=40, n_test=8, seed=0,
                               channel_bias=1.0, device=device)
        spec = LatticeSpec(policies=("pofl", "channel", "deterministic"), seeds=(0,),
                           noise_powers=(1e-10,), n_rounds=n_rounds, eval_every=1)
        return task, spec, POFLConfig(n_devices=4, n_scheduled=2, backend="pallas_fused")

    distributed._cnn_parity_lattice = narrow
    world = dist.get_world_size()
    out = distributed._cnn_parity(2, make_cell_mesh(), make_cell_model_mesh(1, world), "cpu")
    costs = {name: {k: part.pop(k) for k in list(part) if k.endswith("sharded")}
             for name, part in out.items()}
    # a cost's seconds differ by rank: only whether it was timed, and its launches
    return {name: part | {k: {"timed": c["seconds"] > 0, "launches": c["launches"]}
                          for k, c in costs[name].items()}
            for name, part in out.items()}


def lattice(inp) -> dict:
    from repro_torch.sim.lattice import run_lattice

    out = {}
    for name, case in inp.items():
        replay(case["draws"])
        out[name] = run_lattice(**case["kw"], mesh=case["mesh"], device="cpu")
    return out


def train_ranks(inp) -> dict:
    from repro_torch.core.channel import ChannelState
    from repro_torch.flatten_util import tree_leaves
    from repro_torch.launch.distributed import counted_collectives
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.launch.steps import block_of
    from repro_torch.launch.train import POFLTrainer
    from repro_torch.models import api
    from repro_torch.obs.registry import metric_value, reset_metrics
    from repro_torch.optim import optimizers

    def by_rank(value):
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, value)
        return parts

    loss_weights: list = []  # the weight shapes of each model_loss call
    model_loss = api.model_loss

    def recorded_loss(params, *args, **kw):
        loss_weights.append([tuple(x.shape) for x in tree_leaves(params)])
        return model_loss(params, *args, **kw)

    api.model_loss = recorded_loss
    out = {}
    for name, case in inp.items():
        mesh = make_rank_mesh(model=case["model"], n_fl=case["n_fl"], device="cpu")
        opt_name, lr = case["optimizer"]
        seen: list = []
        trainer = POFLTrainer(case["cfg"], case["shape"], mesh, case["tcfg"],
                              optimizer=recording(getattr(optimizers, opt_name)(lr), seen),
                              draws=ReplayDraws(case["draws"]))
        trainer.channel = ChannelState(cfg=trainer.channel.cfg, gains=case["gains"])
        params = block_of(case["params"], trainer.train_bundle.in_shardings["params"])
        opt_state = trainer.optimizer.init(params)
        reset_metrics("ranks.")
        loss_weights.clear()
        rounds = []
        for batch in case["batches"]:
            params, opt_state, diag = trainer.train_round(params, opt_state, batch)
            rounds.append(diag)
        out[name] = {"rounds": rounds,
                     "ranks": by_rank({"coordinates": mesh.coordinates(), "params": params,
                                       "opt_state": opt_state, "grads": seen,
                                       "loss_weights": list(loss_weights),
                                       "compute_weight_bytes":
                                           metric_value("ranks.compute_weight_bytes"),
                                       "collectives": {op: {k: c[k] for k in ("calls", "bytes")}
                                                       for op, c in counted_collectives().items()}})}
    return out


def tp_route(inp) -> dict:
    from repro_torch.flatten_util import tree_map
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.launch.steps import block_of, build_train_step
    from repro_torch.models import api, layers
    from repro_torch.optim.optimizers import sgd

    card = torch.device("cuda")
    mesh = make_rank_mesh(model=2, n_fl=2, device=card)
    params = api.model_init(inp["cfg"], seed=inp["seed"], device=card)
    card_route, fp32_route = layers._Fp32Accumulate, types.SimpleNamespace()
    partials = []

    def counted(a, w):
        partials.append(a.shape)
        return card_route.apply(a, w)

    fp32_route.apply = lambda a, w: a.float() @ w.float()
    grads = {}
    for route, fn in (("card", counted), ("fp32", fp32_route.apply)):
        layers._Fp32Accumulate = types.SimpleNamespace(apply=fn)
        seen: list = []
        bundle = build_train_step(inp["cfg"], inp["shape"], mesh, recording(sgd(0.0), seen),
                                  dtype=torch.bfloat16, aircomp_noise=False)
        blocks = block_of(params, bundle.in_shardings["params"])
        batch = block_of({"tokens": inp["tokens"].to(card)}, bundle.in_shardings["batch"])
        bundle.fn(blocks, sgd(0.0).init(blocks), batch,
                  torch.tensor([0.7, 1.3], device=card), torch.zeros((), device=card), None)
        grads[route] = tree_map(lambda x: x.cpu(), seen[0])
    layers._Fp32Accumulate = card_route
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, {"grads": grads, "card_partials": len(partials)})
    return {"ranks": parts}


def serve_ranks(inp) -> dict:
    from repro_torch.launch.distributed import counted_collectives
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.launch.serve import Server
    from repro_torch.launch.sharding import (
        cache_block, cache_gather, params_pspecs, to_shardings,
    )
    from repro_torch.launch.steps import (
        block_of, build_prefill_step, build_serve_step, params_structs,
    )
    from repro_torch.models.config import InputShape
    from repro_torch.obs.registry import reset_metrics

    def by_rank(value):
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, value)
        return parts

    def collectives():
        return {op: {k: c[k] for k in ("calls", "bytes")}
                for op, c in counted_collectives().items()}

    out = {}
    for name, case in inp.items():
        cfg, tokens = case["cfg"], case["tokens"]
        mesh = make_rank_mesh(model=case["model"], device="cpu")
        server = Server(cfg, case["shape"], mesh, torch.float32)
        params = case["params"]
        if case["load_blocks"]:
            params = block_of(params, to_shardings(params_pspecs(params_structs(cfg), mesh), mesh))
        reset_metrics("ranks.")
        weights = server.load_params(params)
        first, logits, cache = server.prefill(weights, server.batch_block({"tokens": tokens}),
                                              pad_to=case["pad_to"])
        logits = server.gather_logits(logits)
        prefill_collectives = collectives()
        prefilled = type(cache)(*(x.clone() for x in cache))
        reset_metrics("ranks.")
        toks, cache, steps = server.decode(weights, first, cache, tokens.shape[1],
                                           case["n_tokens"], keep_logits=True)
        steps = server.gather_logits(steps)
        whole = server.gather_tokens(toks)
        decode_collectives = collectives()
        rows = server.batch_block({"tokens": tokens})
        prompt = InputShape("prompt", tokens.shape[1], tokens.shape[0], "prefill")
        prefill = build_prefill_step(cfg, prompt, mesh, torch.float32)
        step_logits, step_cache = prefill.fn(block_of(case["params"],
                                                      prefill.in_shardings["params"]), rows)
        whole_cache = cache_gather(step_cache, prefill.out_shardings[1])
        recut = cache_block(whole_cache, mesh)
        serve = build_serve_step(cfg, case["shape"], mesh, torch.float32)
        step_token, _ = serve.fn(block_of(case["params"], serve.in_shardings["params"]), first,
                                 type(prefilled)(*(x.clone() for x in prefilled)),
                                 tokens.shape[1])
        out[name] = {"tokens": whole, "whole_cache": whole_cache,
                     "ranks": by_rank({"coordinates": mesh.coordinates(), "weights": weights,
                                       "first": first, "logits": logits,
                                       "prefill_cache": prefilled, "tokens": toks,
                                       "step_logits": steps, "cache": cache,
                                       "prefill_collectives": prefill_collectives,
                                       "collectives": decode_collectives,
                                       "prefill_step": (step_logits, step_cache),
                                       "recut": recut,
                                       "serve_step_token": step_token})}
    return out


def moe_ranks(inp) -> dict:
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.launch.steps import _weighted_grads, data_group
    from repro_torch.models import layers

    def by_rank(value):
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, value)
        return parts

    def host(route):
        return type(route)(*(x.detach().cpu() if isinstance(x, torch.Tensor) else x
                             for x in route))

    dev = torch.device(inp.get("device", "cpu"))
    mesh = make_rank_mesh(model=1, n_fl=dist.get_world_size(), device=dev)
    data = data_group(mesh)
    ranks = data.size
    out = {}
    for name, case in inp["layer"].items():
        b = case["x"].shape[0]
        x = case["x"][data.rank * b // ranks:(data.rank + 1) * b // ranks].to(dev)
        x.requires_grad_()
        params = (case["params"] if "params" in case else  # else drawn on the device
                  layers.init_moe(torch.Generator(dev).manual_seed(case["seed"]), case["cfg"],
                                  device=dev))
        params = {k: v.to(dev).requires_grad_() for k, v in params.items()}
        with layers.recorded_routes() as seen:
            y, aux = layers.moe_fwd(params, x, case["cfg"], torch.float32, data)
        d_router, d_x = torch.autograd.grad(aux, [params["router"], x])
        out[name] = by_rank({"out": y.detach().cpu(), "aux": aux.detach().cpu(),
                             "route": host(seen[0]), "d_router": d_router.cpu(),
                             "d_x": d_x.cpu()})
    for name, case in inp.get("micro", {}).items():
        n_dev = case["n_fl"] // ranks
        b = case["tokens"].shape[0]
        rows = slice(data.rank * b // ranks, (data.rank + 1) * b // ranks)
        coeffs = case["coeffs"][data.rank * n_dev:(data.rank + 1) * n_dev]
        w = torch.repeat_interleave(coeffs * case["n_fl"], b // case["n_fl"])
        grads_of = _weighted_grads(case["cfg"], torch.float32, True, case["n_micro"],
                                   data=data)
        with layers.recorded_routes() as seen:
            loss, grads = grads_of(case["params"], {"tokens": case["tokens"][rows]}, w, n_dev)
        out[name] = by_rank({"loss": loss, "grads": grads, "routes": [host(r) for r in seen]})
    return out


def main() -> int:
    job, path_in, path_out = sys.argv[1:]
    from repro_torch.sim.multihost import initialize_distributed

    if not initialize_distributed(device="cpu", timeout=60.0):
        raise SystemExit("no REPRO_DIST_* env: start this under repro_torch.launch.distributed")
    inp = torch.load(path_in, weights_only=False) if path_in != "-" else None
    result = {"shard_gather": shard_gather, "allreduce": allreduce, "cnn_parity": cnn_parity,
              "lattice": lattice, "train_ranks": train_ranks, "tp_route": tp_route,
              "serve_ranks": serve_ranks, "moe_ranks": moe_ranks}[job](inp)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, result)
    same = all(_equal(every[0], other) for other in every[1:])
    if dist.get_rank() == 0:
        torch.save({"result": result, "every_rank_equal": same}, path_out)
    dist.destroy_process_group()
    return 0


def _equal(a, b) -> bool:
    """Bitwise equality of two results (nested containers of arrays)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, (np.ndarray, torch.Tensor)):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


if __name__ == "__main__":
    sys.exit(main())
