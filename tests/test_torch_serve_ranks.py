"""The port's ``Server`` over a (data, model) mesh of ranks, held to the
reference's ``api.model_prefill`` / ``model_decode`` on the whole batch and
cache on the CPU.

Gloo ranks run through the port's launcher (``_torch_parity.launch_ranks``,
job ``serve_ranks`` of ``tests/_torch_mesh_worker.py``), in one launch of
two ranks for the two-rank cases and one of four for the (2, 2) case,
while this process runs the reference (its decode step jitted once a cache
shape; every position below 100, ROADMAP C9). Reduced qwen2 (4 query heads,
2 kv heads, d_ff 512, vocab 512) and mamba2 at 2 layers, fp32, weights
converted from the reference by ``convert`` with biases and norm scales
perturbed, a numpy prompt from a seed. The reference's result does not
depend on the mesh. Over 2 model ranks qwen2 and mamba2 are split
tensor-parallel: each rank holds its TP blocks (its heads, MLP columns
and vocabulary block; mamba2's SSM heads with B and C whole). Cases:

- ``fill``: 4 rows, a 16-token prompt in a 24-slot cache on (2, 1) (two
  data ranks of 2 rows), (1, 2) (two model ranks of 12 slots: the prompt
  fills both) and (2, 2) (four ranks: 2 rows and 12 slots each), 6 steps;
- ``short``: a 4-token prompt in a 16-slot cache on (1, 2): rank 1's
  slice is empty until the steps cross the boundary at position 8;
- ``ring``: the reference's unpadded 8-slot cache on (1, 2): slot t % 8
  wraps onto rank 0's slots, then crosses into rank 1's;
- ``mamba2``: on (2, 1), the state split by rows; on (1, 2), the mixer
  split by SSM heads, the state by heads and the conv window by channels;
- ``olmoe``: reduced olmoe (4 experts, top-2) on (2, 1): each rank routes
  its rows in the whole batch's groups (the prefill's 64 tokens one group,
  each decode step's 4 tokens one group), gathering the other rank's
  experts a layer.

Tokens are held exactly (the reference's top-2 margins are asserted to
exceed the tolerance), floats within 1e-5 of the reference's scale. The
``fill`` on (2, 1) and (2, 2), ``short`` and ``mamba2`` ranks load their
blocks of the weights by ``params_pspecs`` (each leaf gathered over every
rank, then cut to its TP block). Each rank's collectives equal the dry
run's reckoning (``launch.dryrun.rank_collectives`` of the prefill and the
serve step).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, assert_margin, launch_ranks, train_case

from repro.models import api as japi
from repro.models import cache as jcache
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.flatten_util import tree_leaves
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import RankMesh, ShapeMesh
from repro_torch.launch.sharding import (
    Sharding, cache_shardings, served_bytes, to_shardings, tp_pspecs,
)
from repro_torch.launch.steps import (
    build_prefill_step, build_serve_step, check_rank_serving, params_structs,
)
from repro_torch.models.cache import cache_leaves
from repro_torch.models.config import InputShape

B = 4
# name → (arch, ranks, ranks a model group, prompt tokens, cache slots (None:
# the prompt's, unpadded), tokens decoded, load the weights as blocks)
CASES = {
    "fill-2x1": ("qwen2-0.5b", 2, 1, 16, 24, 7, True),
    "fill-1x2": ("qwen2-0.5b", 2, 2, 16, 24, 7, False),
    "short-1x2": ("qwen2-0.5b", 2, 2, 4, 16, 9, True),
    "ring-1x2": ("qwen2-0.5b", 2, 2, 8, None, 6, False),
    "mamba2-2x1": ("mamba2-370m", 2, 1, 16, None, 6, True),
    "mamba2-1x2": ("mamba2-370m", 2, 2, 16, None, 6, True),
    "fill-2x2": ("qwen2-0.5b", 4, 2, 16, 24, 7, True),
    "olmoe-2x1": ("olmoe-1b-7b", 2, 1, 16, 24, 7, True),
}


def _shape(prompt, slots) -> InputShape:
    """The server's capacity: B rows, every position the case takes (an
    unpadded ring gets twice its slots: they split as the slots do)."""
    return InputShape("serve", slots or 2 * prompt, B, "decode")


def _reference(jcfg, jp, tokens, slots, n_tokens):
    """The reference on the whole batch → (first tokens, prefill logits,
    prefill cache (padded to ``slots``), decoded tokens (B, n_tokens), each
    step's logits, final cache, the unpadded prefill cache)."""
    logits, unpadded = japi.model_prefill(jp, jcfg, {"tokens": jnp.asarray(tokens)},
                                          jnp.float32)
    cache = unpadded if slots is None else jcache.pad_cache(unpadded, slots)
    prefilled = cache
    decode = jax.jit(lambda p, tok, c, t: japi.model_decode(p, jcfg, tok, c, t, jnp.float32))
    assert_margin(logits[:, -1])
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    toks, steps = [tok], []
    for i in range(n_tokens - 1):
        step, cache = decode(jp, tok, cache, jnp.asarray(tokens.shape[1] + i, jnp.int32))
        assert_margin(step[:, -1])
        tok = jnp.argmax(step[:, -1], axis=-1)[:, None].astype(jnp.int32)
        toks.append(tok)
        steps.append(step[:, -1])
    return (np.asarray(toks[0]), np.asarray(logits), prefilled,
            np.concatenate([np.asarray(x) for x in toks], axis=1),
            np.stack([np.asarray(x) for x in steps], axis=1), cache, unpadded)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's run (one launch a rank count) and the reference's, which
    this process computes while the ranks run."""
    inp, jax_side = {}, {}
    for name, (arch, ranks, model, prompt, slots, n_tokens, blocks) in CASES.items():
        jcfg, tcfg, jp, batch = train_case(arch, b=B, s=prompt, seed=31)
        inp[name] = {"cfg": tcfg, "ranks": ranks, "model": model,
                     "shape": _shape(prompt, slots),
                     "params": lm_params_from_jax(jax.tree.map(jnp.asarray, jp), tcfg,
                                                  device="cpu"),
                     "tokens": torch.as_tensor(batch["tokens"], dtype=torch.int64),
                     "pad_to": slots, "n_tokens": n_tokens, "load_blocks": blocks}
        jax_side[name] = (jcfg, jax.tree.map(jnp.asarray, jp), batch["tokens"])
    counts = sorted({case["ranks"] for case in inp.values()})
    with ThreadPoolExecutor(len(counts)) as pool:
        launched = [pool.submit(launch_ranks, "serve_ranks", n,
                                {k: v for k, v in inp.items() if v["ranks"] == n},
                                tmp_path_factory.mktemp(f"serve_ranks{n}")) for n in counts]
        want = {name: _reference(jcfg, jp, tokens, inp[name]["pad_to"], inp[name]["n_tokens"])
                for name, (jcfg, jp, tokens) in jax_side.items()}
        got = {k: v for job in launched for k, v in job.result().items()}
    return {name: (inp[name], got[name], want[name]) for name in CASES}


def _mesh(case) -> ShapeMesh:
    return ShapeMesh(("data", "model"), (case["ranks"] // case["model"], case["model"]))


def _rows(x, case, coords):
    """The rank's rows of a whole (B, ...) array."""
    n = B // (case["ranks"] // case["model"])
    return np.asarray(x)[coords["data"] * n:(coords["data"] + 1) * n]


def _vocab_block(x, case, coords):
    """The rank's vocabulary block of whole logits (last dim)."""
    n = x.shape[-1] // case["model"]
    return x[..., coords["model"] * n:(coords["model"] + 1) * n]


def _blocks(whole, like, case, coords):
    """The rank's blocks of a whole reference cache (as the port's cache
    type ``like``), by the port's specs."""
    torch_cache = type(like)(*(torch.tensor(np.asarray(x)) for x in whole))
    shardings = cache_shardings(torch_cache, _mesh(case))
    return [x[sh.index(coords, x.shape)] for x, sh in
            zip(cache_leaves(torch_cache), cache_leaves(shardings))]


def _assert_blocks(got, want_whole, case, coords):
    wants = _blocks(want_whole, got, case, coords)
    gots = cache_leaves(got)
    assert len(gots) == len(wants)
    for g, w in zip(gots, wants):
        assert tuple(g.shape) == tuple(w.shape)
        if g.is_floating_point():
            assert_close(g, w)
        else:
            assert torch.equal(g, w.to(g.dtype))


def _split_slots(case) -> bool:
    return case["cfg"].arch_type == "dense" and case["model"] == 2


def _split(case) -> bool:
    """Whether the case's model ranks split its model tensor-parallel."""
    return case["model"] == 2


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_over_ranks_matches_reference(runs, name):
    """Each rank's first tokens and logits are the reference's for its
    rows, and its cache blocks are the specs' blocks of the reference's
    (padded) cache: the sequence over "model", the rows over "data"."""
    case, got, (first, logits, cache, *_) = runs[name]
    for rank in got["ranks"]:
        coords = rank["coordinates"]
        assert np.array_equal(rank["first"].numpy(), _rows(first, case, coords))
        assert_close(rank["logits"], _rows(logits, case, coords))
        _assert_blocks(rank["prefill_cache"], cache, case, coords)
    block, whole = cache_leaves(got["ranks"][0]["prefill_cache"])[0], cache_leaves(cache)[0]
    dim = 2 if _split(case) else 1  # the slots or SSM heads over "model", else the rows
    assert 2 * block.shape[dim] == whole.shape[dim]
    if name.startswith("short"):  # rank 1's slots hold no position yet
        pos = got["ranks"][1]["prefill_cache"].pos
        assert (pos[pos.shape[0] // 2:] == -1).all() and (pos[:4] >= 0).all()


@pytest.mark.parametrize("name", list(CASES))
def test_decode_over_ranks_matches_reference(runs, name):
    """Each rank's decoded tokens and each step's logits for its rows, and
    its final cache blocks (the ring wrapped where the reference's did);
    the tokens gathered over the ranks are the reference's whole batch."""
    case, got, (_, _, _, toks, steps, cache, _) = runs[name]
    assert np.array_equal(got["tokens"].numpy(), toks)
    for rank in got["ranks"]:
        coords = rank["coordinates"]
        assert np.array_equal(rank["tokens"].numpy(), _rows(toks, case, coords))
        assert_close(rank["step_logits"], _rows(steps, case, coords))
        _assert_blocks(rank["cache"], cache, case, coords)
    if name.startswith(("short", "ring")):  # the steps cross from rank 0's slots to rank 1's
        s_max, start = cache.pos.shape[0], case["tokens"].shape[1]
        written = np.arange(start, start + case["n_tokens"] - 1) % s_max
        assert written.min() < s_max // 2 <= written.max()
        assert name.startswith("short") or written.min() == 0  # the ring wrapped


@pytest.mark.parametrize("name", list(CASES))
def test_serving_steps_over_ranks_match_server_and_reference(runs, name):
    """``build_prefill_step``'s function over ranks (the rank's TP blocks
    of the weights and its rows): its vocabulary block of the ``Server``'s
    logits, and the blocks of the reference's unpadded cache, which
    ``cache_gather`` makes whole again and ``cache_block`` cuts back into
    the same blocks; ``build_serve_step``'s function: the ``Server``'s first
    decoded token."""
    case, got, (first, logits, _, toks, _, _, unpadded) = runs[name]
    whole = got["whole_cache"]
    assert type(whole).__name__ == type(unpadded).__name__
    for g, w in zip(cache_leaves(whole), unpadded, strict=True):
        if g.is_floating_point():
            assert_close(g, w)
        else:
            assert np.array_equal(g.numpy(), np.asarray(w))
    for rank in got["ranks"]:
        coords = rank["coordinates"]
        step_logits, step_cache = rank["prefill_step"]
        assert torch.equal(step_logits, _vocab_block(rank["logits"], case, coords))
        _assert_blocks(step_cache, unpadded, case, coords)
        for a, b in zip(cache_leaves(rank["recut"]), cache_leaves(step_cache), strict=True):
            assert torch.equal(a, b)
        assert np.array_equal(rank["serve_step_token"].numpy(), _rows(toks[:, 1:2], case, coords))


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_runs_the_collectives_the_dry_run_reckons(runs, name):
    """Every rank's counted gathers and all-reduces (calls and wire bytes)
    equal ``launch.dryrun.rank_collectives`` of the prefill step and of the
    serve step on the mesh: the load's gathers of the weight blocks; over
    model ranks the embedding's all-reduce, two all-reduces a layer and the
    kv re-layout's gather a layer in the prefill, the embedding's
    all-reduce, the q, k, v gather, the combine's three all-reduces where
    the sequence is split and two all-reduces a layer a step, the greedy
    token's gather, the gathers of the logits' vocabulary blocks; a MoE
    model's gather of the experts over "data" a layer in the prefill and
    in each step; and the tokens' gather over "data". Over model ranks a
    Mamba2 layer runs its norm's and out_proj's all-reduces and its conv
    window's gather in the prefill and in each step."""
    case, got, _ = runs[name]
    mesh, cfg = _mesh(case), case["cfg"]
    prompt = InputShape("prompt", case["tokens"].shape[1], B, "prefill")
    prefill = dryrun.rank_collectives(cfg, build_prefill_step(cfg, prompt, mesh, torch.float32),
                                      mesh, "all-gather", load_blocks=case["load_blocks"],
                                      logits=True, dtype=torch.float32)
    decode = dryrun.rank_collectives(cfg, build_serve_step(cfg, case["shape"], mesh,
                                                           torch.float32),
                                     mesh, "all-gather", n_tokens=case["n_tokens"], logits=True)
    steps, n_layers = case["n_tokens"] - 1, cfg.n_layers
    split = _split(case)
    per_layer = 5 if _split_slots(case) else 2  # the attention's combine, or neither
    assert decode["reduce"]["calls"] == (steps * (1 + per_layer * n_layers) if split else 0)
    assert prefill["reduce"]["calls"] == (1 + 2 * n_layers if split else 0)
    assert (prefill["gather"]["calls"] > 0) == (split or case["load_blocks"])
    assert decode["gather"]["calls"] > 0  # the model group's, or the tokens' over "data"
    assert decode["broadcast"]["calls"] == prefill["broadcast"]["calls"] == 0
    if cfg.moe is not None:  # the experts' gather a layer (every group spans the ranks)
        loads = prefill["gather"]["calls"] - n_layers
        assert loads == sum(not sh.replicated() for sh in _load_specs(cfg, mesh))
        assert decode["gather"]["calls"] == steps * n_layers + 1
    for rank in got["ranks"]:
        assert rank["prefill_collectives"] == prefill
        assert rank["collectives"] == decode


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_serves_its_tp_blocks(runs, name):
    """Each rank's loaded weights are its TP blocks of the whole weights
    (over one model rank, the whole weights), loaded from whole weights or
    from its spec blocks alike; its bytes are 1/M of the split leaves and
    the whole norms, and mamba2's B and C columns and channels whole
    (``sharding.served_bytes``)."""
    case, got, _ = runs[name]
    mesh, cfg = _mesh(case), case["cfg"]
    structs = params_structs(cfg)
    cuts = to_shardings(tp_pspecs(structs, cfg, mesh), mesh)
    whole = case["params"]

    def held(node, cut, coords):
        if isinstance(node, dict):
            return {k: held(node[k], cut[k], coords) for k in node}
        return node[Sharding(mesh, cut.spec).index(coords, node.shape)]

    whole_leaves = sum(x.numel() for k, x in _named_leaves(structs) if k == "scale")
    if case["model"] > 1 and cfg.arch_type == "ssm":  # the mixer's norm split, B and C whole
        s, n_l = cfg.ssm, cfg.n_layers
        whole_leaves += n_l * (2 * s.d_state * (cfg.d_model + s.conv_kernel + 1)
                               - s.d_inner(cfg.d_model))
    split = sum(x.numel() for x in tree_leaves(structs)) - whole_leaves
    for rank in got["ranks"]:
        want = held(whole, cuts, rank["coordinates"])
        pairs = list(zip(_named_leaves(rank["weights"]), _named_leaves(want), strict=True))
        assert all(torch.equal(g, w) for (_, g), (_, w) in pairs)
        nbytes = sum(g.numel() * g.element_size() for (_, g), _ in pairs)
        assert nbytes == served_bytes(structs, cuts, torch.float32)
        assert nbytes == 4 * (split // case["model"] + whole_leaves)


def _load_specs(cfg, mesh):
    """The Shardings of the weights' spec blocks a rank loads (the
    ``params_pspecs`` the server reads them by), as a list."""
    from repro_torch.launch.steps import _param_specs

    return tree_leaves(to_shardings(_param_specs(cfg, InputShape("s", 24, B, "decode"), mesh),
                                    mesh))


def _named_leaves(tree, key=""):
    """(leaf name, leaf) of a dict tree, keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named_leaves(tree[k], k)]
    return [(key, tree)]


def test_one_rank_mesh_is_the_one_card_server_bitwise():
    """A (1, 1) mesh of one gloo rank in this process: the rank ``Server``
    (prefill into a padded cache, decode, the tokens gathered) and
    ``serve_demo`` over it equal the one-card ones bitwise."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.launch.serve import Server, serve_demo
    from repro_torch.models import api

    cfg = configs.reduced_config("qwen2-0.5b")
    shape = InputShape("serve", 32, 2, "decode")
    params = api.model_init(cfg, 4, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(5))

    def run(where):
        server = Server(cfg, shape, where, torch.float32)
        weights = server.load_params(params)
        first, logits, cache = server.prefill(weights, server.batch_block({"tokens": tokens}),
                                              pad_to=20)
        toks, cache, steps = server.decode(weights, first, cache, 12, 6, keep_logits=True)
        return [server.gather_tokens(toks), logits, steps, *cache]

    one = run("cpu")
    demo = serve_demo(cfg, {"tokens": tokens}, 4, torch.float32, seed=2, device="cpu")[0]
    try:
        mesh = make_rank_mesh(model=1, device="cpu")
        assert mesh.shape == {"data": 1, "model": 1}
        ranks = run(mesh)
        demo_ranks = serve_demo(cfg, {"tokens": tokens}, 4, torch.float32, seed=2,
                                device=mesh)[0]
    finally:
        dist.destroy_process_group()
    for a, b in zip(ranks, one, strict=True):
        assert torch.equal(a, b)
    assert torch.equal(demo_ranks, demo)


REFUSED = {  # arch → (data, model), and what the message names
    "olmoe-1b-7b": ((1, 2), "MoE model over 2 model ranks.*expert split"),
    "zamba2-2.7b": ((2, 1), "hybrid"),
    "seamless-m4t-large-v2": ((2, 1), "cross_k"),
    "internvl2-76b": ((1, 1), "VLM"),
}


@pytest.mark.parametrize("arch", list(REFUSED))
def test_serving_over_ranks_refuses_what_a14_10_holds(arch):
    """Hybrid, enc-dec and VLM models on any mesh of ranks and a MoE model
    over model ranks (it waits for the expert split) raise ``ValueError``
    naming ROADMAP A14.10, in both serving steps and in ``Server``; the dry
    run reckons none of their collectives. A dense and an SSM model serve
    on any mesh (``mamba2-1x2`` above runs the SSM split)."""
    from repro_torch.launch.serve import Server

    sizes, what = REFUSED[arch]
    cfg = configs.reduced_config(arch)
    shape = InputShape("serve", 16, 2, "decode")
    mesh = RankMesh(("data", "model"), sizes, device=torch.device("cpu"))
    prompt = InputShape("prompt", 16, 2, "prefill")
    for build in (lambda: build_prefill_step(cfg, prompt, mesh),
                  lambda: build_serve_step(cfg, shape, mesh),
                  lambda: Server(cfg, shape, mesh)):
        with pytest.raises(ValueError, match=rf"{what}.*A14\.10"):
            build()
    shape_mesh = ShapeMesh(("data", "model"), sizes)
    assert dryrun.rank_collectives(cfg, build_serve_step(cfg, shape, shape_mesh),
                                   shape_mesh) is None
    for arch in ("qwen2-0.5b", "mamba2-370m"):  # dense and SSM: any mesh
        for sizes in ((1, 2), (2, 1), (2, 2)):
            check_rank_serving(configs.reduced_config(arch),
                               RankMesh(("data", "model"), sizes, device=torch.device("cpu")))
    for data in (1, 2):  # MoE and SSM: any mesh of one model rank
        for arch in ("olmoe-1b-7b", "mamba2-370m"):
            check_rank_serving(configs.reduced_config(arch),
                               RankMesh(("data", "model"), (data, 1), device=torch.device("cpu")))


def test_dry_run_reckons_the_decode_32k_combine():
    """qwen2-0.5b at decode_32k (128 × 32,768): on (1, 2), split
    tensor-parallel, a step runs 24 × 3 combine all-reduces, 7,168 B of
    max, 7,168 B of l and 458,752 B of o a layer, besides the split's
    all-reduces (the embedding's, two fp32 (128, 896) a layer) and gathers
    (the q, k, v heads a layer, the greedy pairs), and no gather over
    "data" (the rows are whole); on (2, 1) no combine and one gather of the
    tokens; loading the weight blocks adds one gather a split leaf."""
    from repro_torch.models.config import INPUT_SHAPES

    cfg = configs.base_config("qwen2-0.5b")
    shape = INPUT_SHAPES["decode_32k"]

    def reckon(sizes, **kw):
        mesh = ShapeMesh(("data", "model"), sizes)
        return dryrun.rank_collectives(cfg, build_serve_step(cfg, shape, mesh), mesh, **kw)

    one_two = reckon((1, 2))
    split = 128 * 896 * 2 + 24 * 2 * 128 * 896 * 4  # the embedding's and the layers' products
    assert one_two["reduce"] == {"calls": 72 + 1 + 48,
                                 "bytes": 24 * (458_752 + 7_168 + 7_168) + split}
    assert one_two["gather"] == {"calls": 24 + 1,
                                 "bytes": (24 * 128 * 18 * 64 * 2 + 2 * 128 * 16) // 2}
    two_one = reckon((2, 1), n_tokens=9)
    assert two_one["reduce"]["calls"] == 0
    assert two_one["gather"] == {"calls": 1, "bytes": 128 * 9 * 8 // 2}
    loaded = reckon((2, 1), n_tokens=9, load_blocks=True)
    assert loaded["gather"]["calls"] > 1
