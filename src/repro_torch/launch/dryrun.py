"""Dry run: what each step needs a rank, on meta tensors, nothing allocated
(the port's counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles every (architecture × input shape ×
mesh) step against 512 placeholder CPU devices and reads XLA's memory and
cost analyses. The port compiles nothing. For every combination it builds
the step (``launch.steps.build_step``: train_step for train shapes,
prefill / serve_step for inference shapes) on a shape-only mesh
(``launch.mesh.make_production_mesh``, or ``DxM``, ``PxDxM``) and reports:

  * per-rank bytes, from the ported specs (``launch.sharding``): the
    parameters and the optimizer state in the dtypes of the step's
    ``arg_structs``, the batch (train, prefill) or the token and cache
    (decode), and for training the remat-saved residual carries by
    ``auto_microbatches``' own formula (n_layers · B·S·D · 2 bytes / chips
    / microbatches);
  * the step's global FLOPs, by ``torch.utils.flop_counter.FlopCounterMode``
    over the step's function on meta tensors (the kernels' plain versions
    run there: a meta tensor never reaches a kernel);
  * for training, the collectives of one trainer round a rank as the
    port's rank steps issue them on a (data, model) mesh of ranks
    (:func:`rank_collectives`, sketch mode): a gather of every split fp32
    master in the stats step and again in the train step, the gather of
    the sketched statistics, the schedule's broadcast, and the all-reduce
    of every whole gradient leaf (and the loss) over the data ranks; their
    wire bytes by the reference's ring rule (``launch.mesh.wire_bytes``);
  * for serving, the collectives of ``Server`` over ranks
    (:func:`serve_collectives`): a decode step's combine over "model"
    (three all-reduces an attention layer where the KV cache is split by
    sequence), the gather of the tokens over "data", and the gathers of
    loading spec blocks as whole weights; a record reckons one step.
    ``--gather all-reduce`` reckons gloo's gather of CUDA tensors (a
    zero-filled all-reduce of the whole) in place of an all-gather. The
    counts and bytes are those the rank mesh counts as it runs
    (``ranks.<op>.calls`` and ``ranks.<op>.bytes``).

What it does NOT estimate: the reference reads XLA's temporaries
(``temp_bytes``) and so a transient peak from the compiled program; the
port has no compiled program and does not estimate them (``temp_bytes``
and ``peak_bytes`` are ``None``). Nor the collectives of a mesh with a pod
axis (the rank mesh is (data, model)), of a MoE model over data ranks (its
trainer refuses them) or of a serving case the rank ``Server`` refuses
(``launch.steps.check_rank_serving``): ``collectives`` is ``None`` there. On the one-card mesh
``1x1`` a record holds the card's memory (``torch.cuda.mem_get_info``)
when a card is present, and ``fits`` compares the reckoned bytes
(transients left out) with it; without a card both are ``None``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod] \\
      [--both-meshes] [--json out.jsonl]
  python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape prefill_32k \\
      --mesh 1x1 --batch 8 --seq 2048          # one card, a serving shape
  python -m repro_torch.launch.dryrun --arch internvl2-76b --shape prefill_32k \\
      --mesh 1x1 --batch 8 --seq 2048 --layers 12
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

NOT_ESTIMATED = ("temp_bytes and peak_bytes: the reference reads XLA's temporaries from its "
                 "compiled program; the port compiles no program and does not estimate its "
                 "transient peak. collectives: none for a mesh with a pod axis, a MoE model "
                 "training over data ranks, or a serving case the rank Server refuses "
                 "(the rank mesh is (data, model); launch.steps.check_rank_serving)")


def make_mesh(name: str):
    """A shape-only mesh from its name: ``DxM`` → (data, model), ``PxDxM``
    → (pod, data, model); ``16x16`` and ``2x16x16`` are the production
    meshes, ``1x1`` one card."""
    from repro_torch.launch.mesh import ShapeMesh

    sizes = tuple(int(n) for n in name.split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(sizes))
    if names is None:
        raise ValueError(f"mesh {name!r}: give DxM or PxDxM")
    return ShapeMesh(names, sizes)


def residual_bytes(cfg, shape, mesh) -> int:
    """A rank's remat-saved residual carries of a train step:
    ``auto_microbatches``' formula (n_layers · B·S·D · 2 bytes over the
    mesh's chips) over its microbatch count."""
    from repro_torch.launch.steps import auto_microbatches

    n_layers = cfg.n_layers + (cfg.encdec.n_enc_layers if cfg.encdec is not None else 0)
    total = n_layers * shape.global_batch * shape.seq_len * cfg.d_model * 2
    return total // (mesh.devices.size * auto_microbatches(cfg, shape, mesh))


def state_bytes(bundle) -> dict:
    """A rank's bytes of each argument of a step bundle built on a
    shape-only mesh (its ``arg_structs`` laid out by its ``in_shardings``)."""
    from repro_torch.launch.sharding import sharded_bytes

    return {name: sharded_bytes(bundle.arg_structs[name], sh)
            for name, sh in bundle.in_shardings.items()}


def _reckoner(mesh, gather: str):
    """→ (``{op: {"calls", "bytes"}}`` zeroed, ``add(op, ring_op, result, g)``,
    ``gather_of(shape, itemsize, sharding)``): a gather runs over every
    rank, as an all-gather of the blocks or (``gather="all-reduce"``) an
    all-reduce of a zero-filled whole."""
    from repro_torch.launch.mesh import wire_bytes

    n = mesh.size()
    out = {op: {"calls": 0, "bytes": 0} for op in ("gather", "reduce", "broadcast")}

    def add(op, ring_op, result, g):
        out[op]["calls"] += 1
        out[op]["bytes"] += wire_bytes(ring_op, result, g)

    def gather_of(shape, itemsize, sh):
        if sh.replicated():
            return
        if gather == "all-gather":
            add("gather", "all-gather", n * math.prod(sh.block_shape(shape)) * itemsize, n)
        else:
            add("gather", "all-reduce", math.prod(shape) * itemsize, n)

    return out, add, gather_of


def serve_collectives(cfg, bundle, mesh, gather: str = "all-gather", n_tokens: int = 2,
                      load_blocks: bool = False) -> dict | None:
    """The collectives a rank of ``launch.serve.Server`` runs on a mesh of
    ranks shaped like ``mesh`` (``bundle``: the serve step built on it, or
    the prefill step for the load alone): ``{op: {"calls", "bytes"}}``.

    * ``load_blocks``: loading this rank's blocks of the fp32 parameters
      (``params_pspecs``) as whole weights, one gather a split leaf;
    * decoding ``n_tokens`` tokens (``n_tokens − 1`` steps): where the
      KV cache's sequence is split over "model", each attention layer's
      combine a step, three all-reduces over the model group of fp32 per
      row and head: the row max (4 B), the softmax's sum l (4 B) and the
      output o (4 · dh B);
    * gathering the (B, n_tokens) int64 tokens over the ranks.

    Prefill runs none. ``None`` where the rank ``Server`` refuses the case
    (``launch.steps.check_rank_serving``) or the mesh is not (data, model).
    """
    from repro_torch.flatten_util import tree_leaves
    from repro_torch.launch.sharding import Sharding
    from repro_torch.launch.steps import check_rank_serving

    if tuple(mesh.axis_names) != ("data", "model"):
        return None
    try:
        check_rank_serving(cfg, mesh)
    except ValueError:
        return None
    out, add, gather_of = _reckoner(mesh, gather)
    if load_blocks:
        for x, sh in zip(tree_leaves(bundle.arg_structs["params"]),
                         tree_leaves(bundle.in_shardings["params"]), strict=True):
            gather_of(x.shape, x.element_size(), sh)
    if "cache" not in bundle.arg_structs:
        return out
    models = mesh.shape["model"]
    cache, cache_sh = bundle.arg_structs["cache"], bundle.in_shardings["cache"]
    if cfg.arch_type == "dense" and not Sharding(mesh, (cache_sh.k.spec[2],)).replicated():
        rows = cache_sh.k.block_shape(cache.k.shape)[1]
        for _ in range((n_tokens - 1) * cfg.n_layers):
            for width in (1, 1, cfg.head_dim):  # m, l, o
                add("reduce", "all-reduce", rows * cfg.n_heads * width * 4, models)
    token = bundle.arg_structs["token"]
    gather_of((token.shape[0], n_tokens), 8, bundle.in_shardings["token"])
    return out


def rank_collectives(cfg, bundle, mesh, gather: str = "all-gather",
                     n_fl: int | None = None, **serving) -> dict | None:
    """The collectives of one trainer round a rank in sketch mode, as the
    port's rank steps issue them on a mesh of ranks shaped like ``mesh``
    (``bundle`` the train step built on it) over ``n_fl`` FL devices (the
    bundle's: one a data rank): ``{op: {"calls", "bytes"}}``
    for ``gather``, ``reduce`` and ``broadcast``, the bytes a rank's wire
    bytes by the ring rule. A gather runs over every rank, as an all-gather
    of the blocks or (``gather="all-reduce"``) an all-reduce of a
    zero-filled whole. ``None`` where the rank trainer does not run: a
    mesh other than (data, model), a MoE model over data ranks. A serving
    bundle (no ``coeffs``) is reckoned by :func:`serve_collectives`, which
    takes ``serving``'s keywords."""
    from repro_torch.flatten_util import tree_leaves
    from repro_torch.launch.sharding import Sharding

    if "coeffs" not in bundle.arg_structs:
        return serve_collectives(cfg, bundle, mesh, gather, **serving)
    if tuple(mesh.axis_names) != ("data", "model"):
        return None
    r_data, n = mesh.shape["data"], mesh.size()
    if cfg.moe is not None and r_data > 1:
        return None
    n_fl = n_fl or bundle.arg_structs["coeffs"].shape[0]
    out, add, gather_of = _reckoner(mesh, gather)

    masters = list(zip(tree_leaves(bundle.arg_structs["params"]),
                       tree_leaves(bundle.in_shardings["params"]), strict=True))
    for _step in ("stats", "train"):  # each step gathers the whole masters
        for x, sh in masters:
            gather_of(x.shape, x.element_size(), sh)
    # the sketched (mean, var, norm) of each FL device, split over the data ranks
    gather_of((3, n_fl), 4, Sharding(mesh, (None, "data")))
    if r_data > 1:
        for x, _ in masters:  # the fp32 gradients, and the loss
            add("reduce", "all-reduce", x.numel() * x.element_size(), r_data)
        add("reduce", "all-reduce", 4, r_data)
    add("broadcast", "broadcast", 8 * (n_fl + 4), n)  # coeffs, ν, e_com, a, |S| in float64
    return out


def step_flops(bundle, seq_len: int) -> int:
    """The step's global FLOPs: ``FlopCounterMode`` over its function on
    its meta ``arg_structs`` (a decode step's position ``t``, a host
    integer to the model, at the cache's last slot ``seq_len − 1``)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    args = dict(bundle.arg_structs)
    if "t" in args:
        args["t"] = torch.tensor(seq_len - 1, dtype=args["t"].dtype)
    with FlopCounterMode(display=False) as counter:
        bundle.fn(**args)
    return int(counter.get_total_flops())


def card_memory() -> dict | None:
    """The card's name and memory when one is present, else ``None``."""
    import torch

    if not torch.cuda.is_available():
        return None
    return {"name": torch.cuda.get_device_name(0),
            "memory_bytes": int(torch.cuda.mem_get_info(0)[1])}


def run_one(arch: str, shape_name: str, multi_pod: bool = False, verbose: bool = True, *,
            mesh: str | None = None, layers: int | None = None, batch: int | None = None,
            seq: int | None = None, flops: bool = True, flops_cache: dict | None = None,
            gather: str = "all-gather"):
    """The record of one (arch × shape × mesh): ``mesh`` names it (default:
    the production mesh, ``multi_pod`` picking which); ``layers``, ``batch``
    and ``seq`` cut the model's depth and the shape. ``flops_cache`` keeps
    a FLOP count across meshes (it does not depend on the mesh); ``gather``
    how the ranks gather (:func:`rank_collectives`)."""
    from repro_torch import configs
    from repro_torch.launch.steps import build_step
    from repro_torch.models.config import INPUT_SHAPES

    mesh_name = mesh or ("2x16x16" if multi_pod else "16x16")
    shape = INPUT_SHAPES[shape_name]
    if not configs.supports_shape(arch, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "skipped",
                "reason": "pure full-attention arch — no long_500k variant (DESIGN §4)"}
    shape = dataclasses.replace(shape, global_batch=batch or shape.global_batch,
                                seq_len=seq or shape.seq_len)
    cfg = configs.cut_depth(configs.get_config(arch, shape), layers)
    smesh = make_mesh(mesh_name)
    t0 = time.time()
    bundle = build_step(cfg, shape, smesh)
    train = shape.kind == "train"
    args = state_bytes(bundle)
    residual = residual_bytes(cfg, shape, smesh) if train else 0
    coll = rank_collectives(cfg, bundle, smesh, gather)
    t_reckon = time.time() - t0
    key = (arch, shape, layers)
    if flops and flops_cache is not None and key in flops_cache:
        n_flops = flops_cache[key]
    elif flops:
        n_flops = step_flops(bundle, shape.seq_len)
        if flops_cache is not None:
            flops_cache[key] = n_flops
    else:
        n_flops = None
    argument = sum(args.values())
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "ok",
        "n_devices": smesh.devices.size,
        "global_batch": shape.global_batch,
        "seq_len": shape.seq_len,
        "n_layers": cfg.n_layers,
        "memory": {
            "argument_bytes": argument,
            "by_argument": args,
            "residual_bytes": residual,
            "reckoned_bytes": argument + residual,
            "temp_bytes": None,
            "peak_bytes": None,
        },
        "not_estimated": NOT_ESTIMATED,
        "cost": {"flops_global": n_flops},
        "collectives": coll,
        "collective_bytes_per_device": (None if coll is None else
                                        sum(v["bytes"] for v in coll.values())),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "reckon_s": round(t_reckon, 2),
        "seconds": round(time.time() - t0, 2),
    }
    if smesh.devices.size == 1:
        card = card_memory()
        rec["card"] = card
        rec["fits"] = None if card is None else argument + residual <= card["memory_bytes"]
    if verbose:
        flops_txt = "n/a" if n_flops is None else f"{n_flops:.3e}"
        coll_bytes = rec["collective_bytes_per_device"]
        coll_txt = "n/a" if coll_bytes is None else f"{coll_bytes / 2**20:9.1f} MiB/dev"
        print(f"[dryrun] {arch:>22s} × {shape_name:<12s} mesh={mesh_name:>8s}"
              f"  reckoned={rec['memory']['reckoned_bytes'] / 2**30:9.2f} GiB/dev"
              f"  flops={flops_txt}"
              f"  coll={coll_txt}"
              f"  ({rec['seconds']:.1f}s)", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="both production meshes (16x16 and 2x16x16)")
    ap.add_argument("--mesh", action="append", default=[],
                    help="a mesh by name (DxM or PxDxM; 1x1 is one card); repeatable")
    ap.add_argument("--layers", type=int, default=None, help="cut every model to this depth")
    ap.add_argument("--batch", type=int, default=None, help="the shapes' global batch")
    ap.add_argument("--seq", type=int, default=None, help="the shapes' sequence length")
    ap.add_argument("--no-flops", action="store_true", help="skip the FLOP count")
    ap.add_argument("--gather", default="all-gather", choices=("all-gather", "all-reduce"),
                    help="how the ranks gather: all-gather (NCCL, gloo on the CPU) or a "
                         "zero-filled all-reduce (gloo with CUDA tensors)")
    ap.add_argument("--json", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.models.config import INPUT_SHAPES

    archs = list(configs.ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = list(args.mesh)
    if args.both_meshes:
        meshes = ["16x16", "2x16x16"] + meshes
    elif not meshes:
        meshes = ["2x16x16" if args.multi_pod else "16x16"]

    records = []
    failures = 0
    flops_cache: dict = {}
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                try:
                    rec = run_one(arch, shape, mesh=mesh, layers=args.layers, batch=args.batch,
                                  seq=args.seq, flops=not args.no_flops,
                                  flops_cache=flops_cache, gather=args.gather)
                except Exception as e:  # noqa: BLE001 — report and continue
                    rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                    print(f"[dryrun] FAIL {arch} × {shape} × {mesh}: {rec['error']}",
                          flush=True)
                records.append(rec)
                if args.json:
                    with open(args.json, "a") as f:
                        f.write(json.dumps(rec) + "\n")

    ok = sum(1 for r in records if r["status"] == "ok")
    sk = sum(1 for r in records if r["status"] == "skipped")
    print(f"[dryrun] done: {ok} ok, {sk} skipped, {failures} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
