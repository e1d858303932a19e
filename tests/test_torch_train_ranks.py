"""The port's ``POFLTrainer`` over a (data, model) mesh of ranks, held to
the reference's ``POFLTrainer.train_round`` on the CPU, with the port's
one-process trainer as a second witness.

Two gloo ranks run through the port's launcher
(``_torch_parity.launch_ranks``, job ``train_ranks`` of
``tests/_torch_mesh_worker.py``), in ONE launch for every case: reduced
qwen2 and reduced mamba2 at 2 layers, 4 FL devices, 8 × 16 tokens, fp32
compute, on the (2, 1) mesh (two data ranks, two FL devices each) and the
(1, 2) mesh (two model ranks: qwen2 split tensor-parallel on each rank's
TP blocks, ``sharding.tp_pspecs``, and mamba2's mixer split by SSM heads,
B and C whole on every rank), and reduced olmoe
(4 experts, top-2) on the (2, 1) mesh: each rank routes its 64 tokens in
the batch's group of 128 over the data ranks, gathering the other's
experts in every pass, and adds its share of the batch's load-balance
loss. Beside it, one
launch of four gloo ranks runs qwen2 on the (2, 2) mesh for two ``sgd``
rounds: two data ranks, each split over two model ranks. The
reference's round runs in this process over its own functions
(``_torch_parity.reference_trainer``: its sketch and train step, unjitted)
from the same converted weights and batches; the port's rounds take the
reference trainer's draws (``_torch_parity.ReferenceTrainerDraws``: probes,
h, Gumbel vectors, noise) and its channel gains, drawn once here and
replayed. The reference's round does not depend on the mesh.

- Three ``sgd`` rounds: loss, e_com, a, coeffs, noise_amp and the
  sketched statistics within 1e-5 of the reference's relative to their
  scale, n_scheduled and the schedule exactly; every rank's final blocks
  equal the spec's slices of the reference's final parameters within
  1e-5, and each rank holds only its spec's blocks of the masters and the
  optimizer state. The one-process port trainer is held the same way.
- One ``adamw`` round: the noisy gradients that reach the optimizer, each
  rank's blocks against the slices of the reference's gradients (1e-5; as
  ``tests/test_torch_train_step.py`` holds them: AdamW's first step is
  ill-conditioned, ROADMAP C), and each rank's update equal to AdamW's
  update of its own gradients.
- Each rank's collectives (calls and wire bytes, counted by the rank mesh)
  equal the dry run's reckoning for that mesh
  (``launch.dryrun.rank_collectives``) over the rounds.
- Every ``model_loss`` call of a rank's steps (the JVP passes and the
  train step) gets its compute blocks: qwen2's and mamba2's TP blocks over
  two model ranks, never a whole split leaf; the whole model elsewhere.
  Its compute-weight bytes equal the dry run's.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import pytest
import torch
from _torch_mesh_worker import ReplayDraws, recording
from _torch_parity import (
    ReferenceTrainerDraws, assert_close, launch_ranks, reference_trainer, torch_batch,
    train_batch, train_case,
)

from repro.core.channel import ChannelConfig as JChannelConfig
from repro.launch import train as jtrain
from repro.optim import optimizers as jopt
from repro_torch.convert import lm_params_from_jax
from repro_torch.core.channel import ChannelState
from repro_torch.flatten_util import tree_leaves, tree_unflatten
from repro_torch.launch import dryrun
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import ShapeMesh, make_host_mesh
from repro_torch.launch.sharding import Sharding, params_pspecs, to_shardings, tp_pspecs
from repro_torch.launch.steps import build_train_step, params_structs, tp_trains
from repro_torch.models.config import InputShape
from repro_torch.optim import optimizers as topt

N_FL, B, SEQ, LR, SEED = 4, 8, 16, 0.05, 3
ARCHS = ("qwen2-0.5b", "mamba2-370m")
MOE = "olmoe-1b-7b-sgd-2x1"  # reduced olmoe over two data ranks
MESHES = {"2x1": 1, "1x2": 2}  # name → ranks a model group
SPLIT4 = f"{ARCHS[0]}-sgd-2x2"  # the (2, 2) case on four ranks, SPLIT4_ROUNDS rounds
SPLIT4_ROUNDS = 2
ROUNDS = {"sgd": 3, "adamw": 1}
CASES = ((ARCHS[0], "sgd"), (ARCHS[0], "adamw"), (ARCHS[1], "sgd"))  # each sgd before adamw
FIELDS = ("loss", "e_com", "a", "coeffs", "noise_amp", "grad_mean", "grad_var", "grad_norm")


def _case(arch: str, optimizer: str):
    """One trainer case → (the port's inputs: config, shape, TrainerConfig,
    the reference's weights converted, the batches, every round's draws
    from the reference trainer's key discipline and its channel gains;
    the reference's side: its config, TrainerConfig, weights and batches)."""
    jcfg, tcfg, jp, _ = train_case(arch, b=B, s=SEQ, seed=9)
    jbatches = [train_batch(jcfg, b=B, s=SEQ, seed=20 + r) for r in range(ROUNDS[optimizer])]
    tc = ttrain.TrainerConfig(n_scheduled=2, noise_power=1e-10, n_probes=2, dtype="float32",
                              seed=SEED)
    params = lm_params_from_jax(jax.tree.map(jnp.asarray, jp), tcfg, device="cpu")
    ref = ReferenceTrainerDraws(SEED, JChannelConfig(n_devices=N_FL, tx_power=tc.tx_power,
                                                     noise_power=tc.noise_power))
    draws = []
    for _ in jbatches:
        draws.append({"probes": ref.probes(params, tc.n_probes), "h": ref.channel(None),
                      "gumbels": ref.gumbels(tc.n_scheduled, N_FL),
                      "noise": ref.noise(params)})
    port = {"cfg": tcfg, "shape": InputShape("ranks", SEQ, B, "train"), "tcfg": tc,
            "params": params, "batches": [torch_batch(b) for b in jbatches], "draws": draws,
            "gains": ref.gains(), "n_fl": N_FL, "optimizer": (optimizer, LR)}
    reference = {"cfg": jcfg, "tcfg": jtrain.TrainerConfig(**dataclasses.asdict(tc)),
                 "params": jp, "batches": jbatches}
    return port, reference


def _reference(port, reference):
    """The reference's ``train_round`` over the case's batches → (each
    round's values of FIELDS and n_scheduled, its parameters after each
    round and the gradients each update got, both as port trees)."""
    opt_name, lr = port["optimizer"]
    opt, seen = getattr(jopt, opt_name)(lr), []
    ns = reference_trainer(reference["cfg"], reference["tcfg"], N_FL, B, SEED, opt, seen,
                           jit=True)
    logged: list = []
    stats_fn, train_fn = ns.stats_bundle.fn, ns.train_bundle.fn

    def log_stats(params, batch, k):
        logged.append(dict(zip(("grad_mean", "grad_var", "grad_norm"),
                               stats_fn(params, batch, k))))
        return tuple(logged[-1].values())

    def log_train(params, opt_state, batch, coeffs, noise_amp, k_noise):
        logged[-1].update(coeffs=coeffs, noise_amp=noise_amp)
        return train_fn(params, opt_state, batch, coeffs, noise_amp, k_noise)

    ns.stats_bundle.fn, ns.train_bundle.fn = log_stats, log_train
    jp = jax.tree.map(jnp.asarray, reference["params"])
    js = opt.init(jp)
    to_port = lambda tree: lm_params_from_jax(tree, port["cfg"], device="cpu")  # noqa: E731
    rounds, after = [], []
    for batch in reference["batches"]:
        jp, js, diag = jtrain.POFLTrainer.train_round(
            ns, jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        rounds.append({**logged[-1], **diag,
                       "n_scheduled": int((jnp.asarray(logged[-1]["coeffs"]) > 0).sum())})
        after.append(to_port(jp))
    return rounds, after, [to_port(g) for g in seen]


def _one_process(case):
    """The one-process port trainer's rounds of ``case`` → (diags, final
    params, the gradients each round's optimizer got)."""
    seen: list = []
    opt_name, lr = case["optimizer"]
    trainer = ttrain.POFLTrainer(case["cfg"], case["shape"], make_host_mesh(1, N_FL, "cpu"),
                                 case["tcfg"],
                                 optimizer=recording(getattr(topt, opt_name)(lr), seen),
                                 draws=ReplayDraws(case["draws"]))
    trainer.channel = ChannelState(cfg=trainer.channel.cfg, gains=case["gains"])
    params = case["params"]
    opt_state = trainer.optimizer.init(params)
    diags = []
    for batch in case["batches"]:
        params, opt_state, diag = trainer.train_round(params, opt_state, batch)
        diags.append(diag)
    return diags, params, seen


def _mesh(case) -> ShapeMesh:
    """A shape-only copy of the case's rank mesh."""
    return ShapeMesh(("data", "model"), (case.get("data", 2 // case["model"]), case["model"]))


def _shardings(case):
    """The parameters' Shardings on a shape-only copy of the rank mesh."""
    mesh = _mesh(case)
    return mesh, to_shardings(params_pspecs(params_structs(case["cfg"]), mesh), mesh)


def _block(sh: Sharding, whole, coords):
    return whole[sh.index(coords, whole.shape)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's two-rank run (one launch, while this process runs the
    reference's rounds, jitted, and the one-process port trainer's). The
    optimizer acts after a round's gradients, so AdamW's round 0 gets the
    gradients and the schedule of ``sgd``'s round 0 on the same weights,
    batch and draws: the reference's ``sgd`` run serves both."""
    cases = {(arch, opt): _case(arch, opt) for arch, opt in CASES}
    inp = {f"{arch}-{opt}-{mesh}": {**cases[arch, opt][0], "model": model}
           for arch, opt in CASES for mesh, model in MESHES.items()}
    moe_port, moe_reference = _case("olmoe-1b-7b", "sgd")
    inp[MOE] = {**moe_port, "model": 1}
    qwen = cases[ARCHS[0], "sgd"][0]
    split4 = {SPLIT4: {**qwen, "model": 2, "data": 2, "batches": qwen["batches"][:SPLIT4_ROUNDS],
                       "draws": qwen["draws"][:SPLIT4_ROUNDS]}}
    with ThreadPoolExecutor(2) as pool:
        launched = pool.submit(launch_ranks, "train_ranks", 2, inp,
                               tmp_path_factory.mktemp("train_ranks"))
        launched4 = pool.submit(launch_ranks, "train_ranks", 4, split4,
                                tmp_path_factory.mktemp("train_ranks4"))
        ref, want = {}, {}
        for (arch, opt), (port, reference) in cases.items():
            if opt == "sgd":
                ref[arch] = _reference(port, reference)
            rounds, after, seen = ref[arch]
            want[arch, opt] = ((rounds, after[-1], seen) if opt == "sgd" else
                               (rounds[:1], None, seen[:1]), _one_process(port))
        rounds, after, seen = _reference(moe_port, moe_reference)
        want_moe = ((rounds, after[-1], seen), _one_process(moe_port))
        rounds, after, seen = ref[ARCHS[0]]
        n = SPLIT4_ROUNDS
        want4 = ((rounds[:n], after[n - 1], seen[:n]),
                 _one_process({**qwen, "batches": qwen["batches"][:n], "draws": qwen["draws"][:n]}))
        got = {**launched.result(), **launched4.result()}
    out = {f"{arch}-{opt}-{mesh}": (inp[f"{arch}-{opt}-{mesh}"], got[f"{arch}-{opt}-{mesh}"],
                                    *want[arch, opt])
           for arch, opt in CASES for mesh in MESHES}
    out[SPLIT4] = (split4[SPLIT4], got[SPLIT4], *want4)
    out[MOE] = (inp[MOE], got[MOE], *want_moe)
    return out


def _sgd_names():
    return [f"{a}-sgd-{m}" for a in ARCHS for m in MESHES] + [SPLIT4, MOE]


def _assert_rounds(rounds, want):
    assert len(rounds) == len(want)
    for g, w in zip(rounds, want):
        for f in FIELDS:
            assert_close(g[f], w[f])
        assert float(g["n_scheduled"]) == float(w["n_scheduled"])
        assert torch.equal(g["coeffs"] > 0, torch.as_tensor(w["coeffs"]) > 0)


@pytest.mark.parametrize("name", _sgd_names())
def test_three_sgd_rounds_over_ranks_match_one_process(runs, name):
    """Every round against the reference's ``train_round``, and against the
    one-process port trainer."""
    case, got, (rounds, _, _), (diags, _, _) = runs[name]
    assert len(got["rounds"]) == len(case["batches"]) == (SPLIT4_ROUNDS if name == SPLIT4 else 3)
    _assert_rounds(got["rounds"], rounds)
    _assert_rounds(got["rounds"], diags)
    assert all(float(r["n_scheduled"]) == 2 for r in rounds)


@pytest.mark.parametrize("name", _sgd_names())
def test_each_rank_holds_its_spec_blocks_of_the_one_process_parameters(runs, name):
    """Each rank's final blocks are the spec's slices of the reference's
    final parameters (and of the one-process port trainer's); the masters
    and the optimizer state are held as blocks only."""
    case, got, (_, ref_final, _), (_, final, _) = runs[name]
    mesh, p_sh = _shardings(case)
    shardings = tree_leaves(p_sh)
    assert any(not sh.replicated() for sh in shardings)  # something is split
    for rank in got["ranks"]:
        coords = rank["coordinates"]
        blocks, state = tree_leaves(rank["params"]), rank["opt_state"]
        for x, sh, whole, witness in zip(blocks, shardings, tree_leaves(ref_final),
                                         tree_leaves(final), strict=True):
            assert tuple(x.shape) == sh.block_shape(whole.shape)
            assert_close(x, _block(sh, whole, coords))
            assert_close(x, _block(sh, witness, coords))
        for moment in (state.mu, state.nu):
            if moment is not None:
                for x, sh, whole in zip(tree_leaves(moment), shardings, tree_leaves(ref_final)):
                    assert tuple(x.shape) == sh.block_shape(whole.shape)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_adamw_round_gradients_over_ranks_match_one_process(runs, mesh):
    """The noisy gradients that reach AdamW: each rank's blocks against the
    slices of the reference's (and the one-process port trainer's); each
    rank's update is AdamW's update of its own gradients."""
    name = f"{ARCHS[0]}-adamw-{mesh}"
    case, got, (rounds, _, ref_seen), (_, _, seen) = runs[name]
    _, p_sh = _shardings(case)
    shardings = tree_leaves(p_sh)
    _assert_rounds(got["rounds"], rounds)
    opt = topt.adamw(LR)
    for rank in got["ranks"]:
        coords = rank["coordinates"]
        (grads,) = rank["grads"]
        for g, sh, whole, witness in zip(tree_leaves(grads), shardings, tree_leaves(ref_seen[0]),
                                         tree_leaves(seen[0]), strict=True):
            assert_close(g, _block(sh, whole, coords))
            assert_close(g, _block(sh, witness, coords))
        blocks0 = _blocks_of(case["params"], p_sh, coords)
        want, _ = opt.update(grads, opt.init(blocks0), blocks0)
        for x, w in zip(tree_leaves(rank["params"]), tree_leaves(want)):
            assert torch.equal(x, w)


def _blocks_of(tree, p_sh, coords):
    return tree_unflatten(tree, [_block(sh, x, coords).clone() for x, sh in
                                 zip(tree_leaves(tree), tree_leaves(p_sh))])


def _split(case) -> bool:
    """Whether the case's model ranks split its model tensor-parallel."""
    return tp_trains(case["cfg"], _mesh(case))


@pytest.mark.parametrize("name", _sgd_names() + [f"{ARCHS[0]}-adamw-{m}" for m in MESHES])
def test_each_rank_runs_the_collectives_the_dry_run_reckons(runs, name):
    """Every rank's gathers, reductions and broadcasts, counted with their
    wire bytes by the rank mesh as it ran, equal the dry run's reckoning of
    a round on that mesh (gloo on the CPU gathers by all-gather; fp32
    compute, the trainer's two probes) times the rounds: over model ranks
    that split qwen2 or mamba2 the tensor-parallel all-reduces too, and
    over the data ranks that route olmoe the load-balance loss's SUM and
    the experts' gather a layer."""
    case, got, _, _ = runs[name]
    mesh = _mesh(case)
    opt_name, lr = case["optimizer"]
    bundle = build_train_step(case["cfg"], case["shape"], mesh, getattr(topt, opt_name)(lr),
                              dtype=torch.float32)
    per_round = dryrun.rank_collectives(case["cfg"], bundle, mesh, "all-gather", N_FL,
                                        dtype=torch.float32, n_probes=case["tcfg"].n_probes)
    n_rounds = len(case["batches"])
    want = {op: {k: v * n_rounds for k, v in c.items()} for op, c in per_round.items()}
    assert want["gather"]["calls"] > 0 and want["broadcast"]["calls"] == n_rounds
    assert (want["reduce"]["calls"] > 0) == (mesh.shape["data"] > 1 or _split(case))
    if name == MOE:  # a layer gathers the experts in 3 JVP passes, the forward, the recompute
        n_layers, masters = case["cfg"].n_layers, tree_leaves(bundle.in_shardings["params"])
        split = sum(not sh.replicated() for sh in masters)
        assert want["gather"]["calls"] == n_rounds * (2 * split + 1 + 5 * n_layers)
        # every gradient leaf and the loss, and the aux's SUM a layer (forward, recompute)
        assert want["reduce"]["calls"] == n_rounds * (len(masters) + 1 + 2 * n_layers)
    for rank in got["ranks"]:
        assert rank["collectives"] == want


@pytest.mark.parametrize("name", _sgd_names())
def test_each_rank_differentiates_its_compute_blocks(runs, name):
    """Every ``model_loss`` call of a rank's steps (1 + 2 JVP passes and
    the train step a round) gets its compute blocks: over model ranks that
    split qwen2 or mamba2 each split leaf is its TP block, never the whole
    leaf, and the norms whole; elsewhere the whole model. The rank's
    compute-weight bytes are the dry run's."""
    case, got, _, _ = runs[name]
    mesh = _mesh(case)
    structs = params_structs(case["cfg"])
    whole = [tuple(x.shape) for x in tree_leaves(structs)]
    want = whole
    if _split(case):
        tp = to_shardings(tp_pspecs(structs, case["cfg"], mesh), mesh)
        want = [sh.block_shape(x.shape) for x, sh in zip(tree_leaves(structs), tree_leaves(tp))]
        assert all(w != x for w, x, sh in zip(want, whole, tree_leaves(tp))
                   if not sh.replicated())
    for rank in got["ranks"]:
        assert rank["loss_weights"] == [want] * (len(case["batches"]) * (1 + 2 + 1))
        assert rank["compute_weight_bytes"] == dryrun.compute_weight_bytes(case["cfg"], mesh)


def test_one_rank_mesh_is_the_one_card_trainer_bitwise():
    """A (1, 1) mesh of one gloo rank in this process: a round of the rank
    trainer equals the one-card trainer's bitwise; a mesh the ranks cannot
    form, and collectives on the shape-only production mesh, raise."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import batch_ways, make_production_mesh, make_rank_mesh

    case, _ = _case(ARCHS[0], "sgd")
    case["batches"], case["draws"] = case["batches"][:1], case["draws"][:1]
    diags, final, _ = _one_process(case)
    try:
        mesh = make_rank_mesh(model=1, n_fl=N_FL, device="cpu")
        assert mesh.shape == {"data": 1, "model": 1} and batch_ways(mesh) == N_FL
        with pytest.raises(ValueError, match="model groups of 2"):
            make_rank_mesh(model=2, n_fl=N_FL, device="cpu")
        trainer = ttrain.POFLTrainer(case["cfg"], case["shape"], mesh, case["tcfg"],
                                     optimizer=topt.sgd(LR), draws=ReplayDraws(case["draws"]))
        trainer.channel = ChannelState(cfg=trainer.channel.cfg, gains=case["gains"])
        params, opt_state, diag = trainer.train_round(
            case["params"], trainer.optimizer.init(case["params"]), case["batches"][0])
    finally:
        dist.destroy_process_group()
    for f in ("loss", "e_com", "a", "coeffs", "noise_amp", "n_scheduled"):
        assert torch.equal(diag[f], diags[0][f]), f
    for x, w in zip(tree_leaves(params), tree_leaves(final)):
        assert torch.equal(x, w)
    production = make_production_mesh()
    with pytest.raises(ValueError, match="shape-only"):
        production.coordinates()
    with pytest.raises(ValueError, match="shape-only"):
        production.collective("gather")
    assert dataclasses.asdict(production) == {"axis_names": ("data", "model"),
                                              "axis_sizes": (16, 16)}


def test_rank_slice_takes_a_moe_model_over_data_ranks():
    """A MoE model's routing groups and load-balance loss span the batch,
    and its steps route over the data group: the (2, 1) mesh splits its FL
    devices over the data ranks as any model's, and the (1, 2) mesh keeps
    them whole on every rank."""
    from types import SimpleNamespace

    from repro_torch import configs
    from repro_torch.launch.steps import _rank_slice, build_train_step

    def mesh(data, rank=0):
        return SimpleNamespace(shape={"data": data, "model": 2 // data}, n_fl=4,
                               coordinates=lambda: {"data": rank, "model": 0})

    assert tuple(_rank_slice(mesh(2))) == (2, 0, 2)
    assert tuple(_rank_slice(mesh(2, rank=1))) == (2, 2, 2)
    assert tuple(_rank_slice(mesh(1))) == (1, 0, 4)
    cfg = configs.reduced_config("olmoe-1b-7b")
    shape_mesh = ShapeMesh(("data", "model"), (2, 1))
    bundle = build_train_step(cfg, InputShape("t", 16, 8, "train"), shape_mesh, topt.sgd(LR))
    assert dryrun.rank_collectives(cfg, bundle, shape_mesh, n_fl=4)["reduce"]["calls"] > 0
