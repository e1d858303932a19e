"""Sharding rules: parameters (FSDP + tensor parallel), batches, caches and
activations (port of ``repro.launch.sharding``).

Rules (DESIGN.md §5):
  * params: last dim divisible by |model| → "model" (tensor parallel);
    largest remaining dim divisible by |fsdp| → ("pod","data") (FSDP).
    Leaves under a stacked layer axis skip their leading layer dim.
  * activations/batches: batch dim over ("pod","data") when divisible.
  * KV caches: batch over ("pod","data"), *sequence* over "model"
    (flash-decoding style — uniform across archs regardless of kv_heads).
  * SSM state: batch over ("pod","data"), heads over "model".

A spec is a tuple with one entry a dim: ``None`` (whole), an axis name, or
a tuple of axis names, as a ``jax.sharding.PartitionSpec`` lists them. A
mesh is read only through its axis names and sizes (``mesh_dim_names`` and
``size(i)``, or ``axis_names`` and ``shape``), so the functions take the
shape-only production mesh, a mesh of ranks and the lattice's
``("cells", "model")`` ``DeviceMesh`` alike.

:func:`to_shardings` gives each spec its :class:`Sharding`: the spec on
its mesh, with a rank's block of a whole tensor (:meth:`Sharding.block`)
and the whole tensor from the ranks' blocks (:meth:`Sharding.gather`).
The port's eager layers apply no activation spec (there is no GSPMD to
read one): :func:`activation_specs` is reported by the dry run and held by
the tests.

Over model ranks a dense or SSM model's products split instead (tensor
parallelism): :func:`tp_pspecs` gives each leaf's TP block, the spec a
model rank serves and trains on (its :class:`Sharding` cuts it from the
whole leaf, :func:`served_bytes` counts a rank's bytes of them). A Mamba2
leaf's TP block is not one contiguous slice: its dim is a
:class:`Segments` entry, consecutive parts each split or whole.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.launch.mesh import wire_bytes
from repro_torch.models.cache import AttnCache, EncDecCache, HybridCache, SSMCache, seq_splits

MIN_SHARD_SIZE = 4096  # leaves smaller than this stay whole

_BATCH_AXES = ("pod", "data")


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` of ``mesh``, in its axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return {a: int(n) for a, n in dict(mesh.shape).items()}
    return {a: int(mesh.size(i)) for i, a in enumerate(names)}


def _fsdp_axes(mesh) -> tuple[str, ...]:
    """The mesh axes that carry (FL-device ×) batch parallelism."""
    return tuple(a for a in axis_sizes(mesh) if a in _BATCH_AXES)


def _fsdp_ways(mesh) -> int:
    """The product of the batch axes' sizes (the reference's ``batch_ways``)."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _fsdp_axes(mesh))


def _model_size(mesh) -> int:
    return axis_sizes(mesh)["model"]


def param_spec(shape, mesh, skip_leading: int = 0) -> tuple:
    """The spec of a parameter leaf of ``shape`` on ``mesh`` (module
    docstring); ``skip_leading`` dims (a stacked layer axis) stay whole."""
    spec: list = [None] * len(shape)
    dims = list(range(skip_leading, len(shape)))
    if not dims or math.prod(shape[d] for d in dims) < MIN_SHARD_SIZE:
        return tuple(spec)

    msize = _model_size(mesh)
    fax = _fsdp_axes(mesh)
    fsize = _fsdp_ways(mesh)

    model_dim = None
    for d in reversed(dims):
        if shape[d] % msize == 0 and shape[d] >= msize:
            spec[d] = "model"
            model_dim = d
            break

    cands = [d for d in dims
             if d != model_dim and shape[d] % fsize == 0 and shape[d] >= fsize]
    if cands and fax:
        d = max(cands, key=lambda i: shape[i])
        spec[d] = fax if len(fax) > 1 else fax[0]
    return tuple(spec)


_STACKED_KEYS = ("layers", "enc_layers")


def _is_stacked(path) -> bool:
    return any(k in _STACKED_KEYS for k in path)


def _is_moe(path) -> bool:
    return any(k == "moe" for k in path)


def _path_leaf_name(path) -> str:
    return str(path[-1])


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict, ``path`` its keys."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def moe_strategy(cfg, shape, mesh) -> str | None:
    """"ep" (experts over "model") vs "dp" (groups over "model", expert
    weights gathered): the reference's choice (its §Perf iteration 8). EP's
    scatter/gather costs all-reduces of the full token tensor over the
    model axis, so EP pays only when the expert weights outweigh the
    dispatched tokens (big experts or few tokens, as in decode); training
    keeps EP."""
    if cfg.moe is None:
        return None
    msize = _model_size(mesh)
    moe = cfg.moe
    if moe.n_experts % msize:
        return "dp"
    if shape.kind == "train":
        return "ep"
    n_tok = shape.global_batch * (shape.seq_len if shape.kind == "prefill" else 1)
    token_bytes = n_tok * moe.top_k * cfg.d_model * 4 * 2
    weight_bytes = 3 * moe.n_experts * cfg.d_model * moe.d_ff_expert * 2 * 3
    return "dp" if weight_bytes < token_bytes else "ep"


def params_pspecs(params_shape, mesh, moe_mode: str | None = "ep"):
    """The spec tree of a params (shape) tree.

    Special cases: the embedding table shards VOCAB over "model" and d_model
    over FSDP (and lm_head the transpose), so the output head contracts
    into vocab-sharded logits locally. MoE expert weights (L, E, D, F)
    follow ``moe_mode`` ("ep": E over "model"; "dp": model-replicated),
    FSDP on the bigger of D and F either way.
    """
    msize = _model_size(mesh)
    fax = _fsdp_axes(mesh)
    fsize = _fsdp_ways(mesh)
    f_axes = fax if len(fax) > 1 else fax[0]

    def leaf_spec(path, leaf):
        name = _path_leaf_name(path)
        shape = tuple(leaf.shape)
        if name == "embed" and len(shape) == 2:
            v_ok = shape[0] % msize == 0
            d_ok = shape[1] % fsize == 0
            return ("model" if v_ok else None, f_axes if d_ok else None)
        if name == "lm_head" and len(shape) == 2:
            d_ok = shape[0] % fsize == 0
            v_ok = shape[1] % msize == 0
            return (f_axes if d_ok else None, "model" if v_ok else None)
        if name in ("w_gate", "w_in", "w_out") and len(shape) == 4 and _is_moe(path):
            e_ok = moe_mode == "ep" and shape[1] % msize == 0
            d_dim = 2 if shape[2] >= shape[3] else 3
            spec = [None, "model" if e_ok else None, None, None]
            if shape[d_dim] % fsize == 0:
                spec[d_dim] = f_axes
            return tuple(spec)
        return param_spec(shape, mesh, skip_leading=1 if _is_stacked(path) else 0)

    return _map_with_path(leaf_spec, params_shape)


# --------------------------------------------------------------------------
# tensor-parallel serving: a model rank's TP blocks
# --------------------------------------------------------------------------

# leaves a server keeps in fp32 whatever its type: the norm scales
# (``rmsnorm`` multiplies in fp32; an enc-dec model's ``enc_norm`` and
# ``ln_x`` too) and Mamba2's dt bias and A_log (dt and the log decay are fp32)
FP32_LEAVES = ("scale", "dt_bias", "A_log")


TP_FAMILIES = ("dense", "ssm")  # the families tensor parallelism splits (tp_pspecs)


class NotDivisible(ValueError):
    """The model ranks do not divide a dimension that tensor parallelism
    splits."""


# leaf name → the dim a model rank's TP block splits, counted from the end:
# the columns of the query and kv heads (a GQA group stays on one rank), the
# rows of the output projections, the MLP's columns and rows, the vocabulary
_TP_DIM = {"wq": -1, "bq": -1, "wk": -1, "bk": -1, "wv": -1, "bv": -1, "wo": -2,
           "w_gate": -1, "w_in": -1, "w_out": -2, "embed": -2, "lm_head": -1}
# a Mamba2 leaf's (by its path under "mamba") TP dim, counted from the end:
# its heads (A_log, dt_bias, D), their channels (the mixer norm's scale), the
# rows of out_proj; in_proj, conv_w and conv_b are segmented (_mamba_segments)
_MAMBA_TP_DIM = {("A_log",): -1, ("dt_bias",): -1, ("D",): -1, ("norm", "scale"): -1,
                 ("out_proj",): -2}


def _mamba_segments(cfg) -> dict:
    """in_proj's last dim, [z (di), x (di), B (n), C (n), dt (nh)], and
    conv_w's and conv_b's, [x (di), B (n), C (n)], as :class:`Segments`: a
    rank's heads' z, x and dt over "model", B and C whole (one B/C group
    feeds every head)."""
    s = cfg.ssm
    di, n, nh = s.d_inner(cfg.d_model), s.d_state, s.n_heads(cfg.d_model)
    conv = Segments(((di, "model"), (2 * n, None)))
    return {("in_proj",): Segments(((di, "model"), (di, "model"), (2 * n, None),
                                    (nh, "model"))),
            ("conv_w",): conv, ("conv_b",): conv}


def _undivided(cfg, msize: int) -> list[str]:
    """The dimensions tensor parallelism splits that ``msize`` model ranks
    do not divide, each as "name = value"."""
    dims = {"vocab_padded": cfg.vocab_padded}
    if cfg.arch_type == "ssm":
        dims = {"ssm.n_heads": cfg.ssm.n_heads(cfg.d_model), **dims}
    else:
        dims = {d: getattr(cfg, d) for d in ("n_heads", "n_kv_heads", "d_ff")} | dims
    return [f"{name} = {value}" for name, value in dims.items() if value % msize]


def tp_pspecs(params_shape, cfg, mesh):
    """The spec tree of a dense or SSM model's TP blocks on ``mesh``.

    A dense model's rank r of M holds query heads ``[r·H/M, (r+1)·H/M)`` of
    ``wq`` / ``bq``, the same block of kv heads of ``wk``, ``wv``, ``bk``,
    ``bv``, the rows of its query heads of ``wo``, columns ``[r·F/M,
    (r+1)·F/M)`` of ``w_gate`` and ``w_in`` and those rows of ``w_out``.
    An SSM (Mamba2) model's holds its nh/M heads: their z, x and dt columns
    of ``in_proj`` with the B and C columns whole, their x channels of
    ``conv_w`` and ``conv_b`` with the B and C channels whole (both
    :class:`Segments`), their ``A_log``, ``dt_bias``, ``D``, the mixer
    norm's channels and ``out_proj``'s rows. Either holds rows (the
    vocabulary) ``[r·V/M, (r+1)·V/M)`` of ``embed`` (columns of
    ``lm_head``); ``ln1``, ``ln2`` and the final norm whole, and everything
    whole over "data". The column and vocab blocks are the spec's "model"
    blocks (:func:`params_pspecs`); ``wo``, ``w_out`` and ``out_proj`` are
    split by rows where the spec splits their last dim. With one model
    rank every leaf is whole, whatever the family. Raises
    :class:`NotDivisible` (a ``ValueError``) naming each dimension that M
    does not divide."""
    msize = _model_size(mesh)
    if msize == 1:
        return _map_with_path(lambda path, leaf: (None,) * leaf.dim(), params_shape)
    if cfg.arch_type not in TP_FAMILIES:
        raise ValueError(f"{cfg.name}: tensor parallelism takes a dense or SSM model, "
                         f"not {cfg.arch_type}")
    undivided = _undivided(cfg, msize)
    if undivided:
        raise NotDivisible(f"{cfg.name}: {msize} model ranks do not divide "
                           + ", ".join(undivided))
    segments = _mamba_segments(cfg) if cfg.arch_type == "ssm" else {}

    def leaf_spec(path, leaf):
        spec = [None] * leaf.dim()
        within = path[path.index("mamba") + 1:] if "mamba" in path else None
        if within is None and _path_leaf_name(path) in _TP_DIM:
            spec[_TP_DIM[_path_leaf_name(path)]] = "model"
        elif within in _MAMBA_TP_DIM:
            spec[_MAMBA_TP_DIM[within]] = "model"
        elif within in segments:
            spec[-1] = segments[within]
        return tuple(spec)

    return _map_with_path(leaf_spec, params_shape)


def served_bytes(params_shape, shardings, dtype) -> int:
    """One rank's bytes of the weights a server holds: each leaf's block by
    its :class:`Sharding` in ``shardings`` (a tree like ``params_shape``:
    the TP blocks, :func:`tp_pspecs`) in ``dtype``, the ``FP32_LEAVES`` in
    fp32."""
    itemsize = torch.empty((), dtype=dtype).element_size()

    def nbytes(path, leaf):
        block = math.prod(_get_path(shardings, path).block_shape(leaf.shape))
        return block * (4 if _path_leaf_name(path) in FP32_LEAVES else itemsize)

    return sum(leaves(_map_with_path(nbytes, params_shape)))


def _get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _batched(shape_b, mesh):
    """Batch-dim spec entry: over ("pod","data") when divisible, else over
    "data" alone when that divides, else whole."""
    fax = _fsdp_axes(mesh)
    if shape_b % _fsdp_ways(mesh) == 0:
        return fax if len(fax) > 1 else fax[0]
    sizes = axis_sizes(mesh)
    if "data" in sizes and shape_b % sizes["data"] == 0:
        return "data"
    return None


def batch_pspecs(batch_struct, mesh):
    """Specs for a train/prefill batch dict {tokens, [embeds|frames]}."""
    return {k: (_batched(v.shape[0], mesh),) + (None,) * (v.dim() - 1)
            for k, v in batch_struct.items()}


def _seq_spec(seq_len, mesh):
    return "model" if seq_splits(seq_len, _model_size(mesh)) else None


def cache_pspecs(cache_struct, mesh):
    """Specs for decode caches (AttnCache / SSMCache / Hybrid / EncDec)."""
    msize = _model_size(mesh)

    def attn_specs(c: AttnCache):
        _, b, s, _, _ = c.k.shape
        kvspec = (None, _batched(b, mesh), _seq_spec(s, mesh), None, None)
        return AttnCache(k=kvspec, v=kvspec, pos=(None,))

    def ssm_specs(c: SSMCache):
        _, b, h, _, _ = c.state.shape
        bs = _batched(b, mesh)
        hs = "model" if h % msize == 0 else None
        cs = "model" if c.conv.shape[-1] % msize == 0 else None
        return SSMCache(state=(None, bs, hs, None, None), conv=(None, bs, None, cs))

    if isinstance(cache_struct, HybridCache):
        return HybridCache(ssm=ssm_specs(cache_struct.ssm), attn=attn_specs(cache_struct.attn))
    if isinstance(cache_struct, EncDecCache):
        _, b, s_enc, _, _ = cache_struct.cross_k.shape
        xs = (None, _batched(b, mesh), _seq_spec(s_enc, mesh), None, None)
        return EncDecCache(self_attn=attn_specs(cache_struct.self_attn), cross_k=xs,
                           cross_v=xs)
    if isinstance(cache_struct, SSMCache):
        return ssm_specs(cache_struct)
    return attn_specs(cache_struct)


def activation_specs(cfg, shape, mesh) -> dict:
    """Shardings of the reference's named activation cut-points.

    residual: attention-family archs shard the SEQUENCE over "model"
    (sequence parallelism); SSM/hybrid archs shard d_model instead (the SSD
    chunk scan iterates the sequence). moe_buffer: expert dim over "model"
    ("ep") or groups over every axis ("dp"). Decode steps get only
    moe_buffer. The port's eager layers do not apply them.
    """
    from repro_torch.models.layers import _moe_group_size

    msize = _model_size(mesh)
    bt = _batched(shape.global_batch, mesh)
    out = {}
    if shape.kind in ("train", "prefill"):
        dspec = "model" if cfg.d_model % msize == 0 else None
        if cfg.arch_type in ("ssm", "hybrid"):
            out["residual"] = (bt, None, dspec)
        else:
            sspec = "model" if shape.seq_len % msize == 0 else None
            out["residual"] = (bt, sspec, None)
        out["ce_input"] = (bt, None, dspec)
    if cfg.moe is not None:
        if shape.kind in ("train", "prefill"):
            n_tok = shape.global_batch * shape.seq_len
        else:
            n_tok = shape.global_batch
        n_groups = n_tok // _moe_group_size(n_tok)
        ways = _fsdp_ways(mesh)
        if moe_strategy(cfg, shape, mesh) == "dp":
            full = ways * msize
            if n_groups % full == 0 and n_groups >= full:
                gspec = tuple(axis_sizes(mesh))
            elif n_groups % ways == 0 and n_groups >= ways:
                gspec = bt
            else:
                gspec = None
            out["moe_buffer"] = (gspec, None, None, None)
        else:
            gspec = bt if (n_groups % ways == 0 and n_groups >= ways) else None
            espec = "model" if cfg.moe.n_experts % msize == 0 else None
            out["moe_buffer"] = (gspec, espec, None, None)
    return {k: Sharding(mesh, v) for k, v in out.items()}


# --------------------------------------------------------------------------
# a spec on its mesh
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segments:
    """A spec entry: a dim made of consecutive segments, ``parts`` its
    (length, entry) pairs in order, each entry ``None`` (the segment whole
    on every rank) or axis names (the segment split over them as a dim of
    that length would be). A rank's block is its block of every segment,
    concatenated in order. A spec holds at most one."""

    parts: tuple

    def length(self) -> int:
        return sum(n for n, _ in self.parts)


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, Segments):
        return tuple(dict.fromkeys(a for _, e in entry.parts for a in _entry_axes(e)))
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _is_spec(x) -> bool:
    """A spec: a plain tuple of ``None``, axis names, tuples of them and
    :class:`Segments` (a cache's NamedTuple of specs is a container, not a
    spec)."""
    return type(x) is tuple and all(
        e is None or isinstance(e, (str, Segments))
        or (type(e) is tuple and all(isinstance(a, str) for a in e))
        for e in x)


def _map_specs(fn, tree):
    """``fn(spec)`` over every spec of a tree of dicts, lists, NamedTuples
    and ``None`` (kept as ``None``)."""
    if tree is None:
        return None
    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_specs(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on its mesh (the port's ``NamedSharding``).

    A dim whose entry names axes is split evenly over the product of their
    sizes, the first axis major, as JAX lays it out; a rank's block along
    it is its place on those axes. A :class:`Segments` dim is split so
    segment by segment, and a rank's block along it is an index list, not a
    slice. On a mesh of ranks
    (:class:`repro_torch.launch.mesh.RankMesh`) :meth:`block` cuts this
    rank's block and :meth:`gather` rebuilds the whole tensor; on the
    shape-only production mesh only :meth:`block_shape` applies.
    """

    mesh: object
    spec: tuple

    def _ways(self, entry) -> int:
        sizes = axis_sizes(self.mesh)
        return math.prod(sizes[a] for a in _entry_axes(entry))

    def _place(self, entry, coords: dict) -> int:
        """The block's place along ``entry``'s axes at ``coords``."""
        sizes = axis_sizes(self.mesh)
        k = 0
        for a in _entry_axes(entry):
            k = k * sizes[a] + coords[a]
        return k

    def _block_len(self, entry, n: int, d: int, shape) -> int:
        if isinstance(entry, Segments):
            if entry.length() != n:
                raise ValueError(f"dim {d} of {shape} is not {entry.length()} long ({self.spec})")
            return sum(self._block_len(e, m, d, shape) for m, e in entry.parts)
        if n % self._ways(entry):
            raise ValueError(f"dim {d} of {shape} does not split {self._ways(entry)} ways "
                             f"({self.spec})")
        return n // self._ways(entry)

    def block_shape(self, shape) -> tuple[int, ...]:
        """A rank's block of a whole tensor of ``shape`` (every split dim
        must divide: the spec functions only split dims that do)."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more dims than shape {shape}")
        out = list(shape)
        for d, entry in enumerate(self.spec):
            out[d] = self._block_len(entry, shape[d], d, shape)
        return tuple(out)

    def _whole_len(self, entry, n: int) -> int:
        """A dim's whole length from a block's ``n`` along it."""
        return entry.length() if isinstance(entry, Segments) else n * self._ways(entry)

    def replicated(self) -> bool:
        return all(self._ways(e) == 1 for e in self.spec)

    def index(self, coords: dict, shape) -> tuple:
        """The index of the block at mesh ``coords`` (``{axis: place}``) in
        a whole tensor of ``shape``: a slice a dim, an index list along a
        :class:`Segments` dim."""
        index = []
        for d, entry in enumerate(self.spec):
            if isinstance(entry, Segments):
                rows, lo = [], 0
                for m, e in entry.parts:
                    n = m // self._ways(e)
                    k = lo + self._place(e, coords) * n
                    rows += range(k, k + n)
                    lo += m
                index.append(rows)
                continue
            n = shape[d] // self._ways(entry)
            k = self._place(entry, coords)
            index.append(slice(k * n, (k + 1) * n))
        return tuple(index)

    def block(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``whole``: a contiguous copy, or ``whole``
        itself where the spec splits nothing."""
        self.block_shape(whole.shape)
        if self.replicated():
            return whole
        return whole[self.index(self.mesh.coordinates(), whole.shape)].clone(
            memory_format=torch.contiguous_format)

    def holds(self, inner: "Sharding") -> bool:
        """Whether every rank's block by ``inner`` lies inside its block by
        this spec: on each dim this spec is whole or splits it over the same
        axes as ``inner`` (axes of size 1 aside; a :class:`Segments` dim
        only as the same segments), which holds for every rank alike."""
        sizes = axis_sizes(self.mesh)
        n = max(len(self.spec), len(inner.spec))

        def split(spec, d):
            entry = spec[d] if d < len(spec) else None
            axes = tuple(a for a in _entry_axes(entry) if sizes[a] > 1)
            return entry if axes and isinstance(entry, Segments) else axes

        return all(not split(self.spec, d) or split(self.spec, d) == split(inner.spec, d)
                   for d in range(n))

    def cut(self, inner: "Sharding", block: torch.Tensor, shape) -> torch.Tensor:
        """This rank's block by ``inner`` of a whole tensor of ``shape``,
        cut from ``block``, its block by this spec (:meth:`holds` must be
        true): a contiguous copy, or ``block`` itself where they are one."""
        if tuple(inner.block_shape(shape)) == tuple(block.shape):
            return block
        coords = self.mesh.coordinates()
        rel = []
        for o, w in zip(self.index(coords, shape), inner.index(coords, shape)):
            if o == w:
                rel.append(slice(None))
            elif isinstance(w, list):  # a whole dim of this spec, segmented in inner
                rel.append([i - o.start for i in w])
            else:
                rel.append(slice(w.start - o.start, w.stop - o.start))
        return block[tuple(rel)].clone(memory_format=torch.contiguous_format)

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's ``block`` (a collective over
        the mesh's ranks; ``block`` itself where nothing is split).

        NCCL, and gloo on the CPU, all-gather the blocks. gloo takes no
        all-gather of a CUDA tensor, so there each rank writes its block
        into a zero-filled whole (only one rank of a group that holds the
        same block: the one at place 0 on every axis the spec does not
        name; along a :class:`Segments` dim a whole segment only by the
        rank at place 0 on the dim's axes) and the wholes are summed by an
        all-reduce: exact, at twice the all-gather's wire bytes.
        """
        if self.replicated():
            return block
        import torch.distributed as dist

        sizes = axis_sizes(self.mesh)
        spec = self.spec + (None,) * (block.dim() - len(self.spec))
        whole_shape = tuple(self._whole_len(e, n) for n, e in zip(block.shape, spec))
        named = {a for e in self.spec for a in _entry_axes(e)}
        by_gather = self.mesh.backend == "nccl" or block.device.type == "cpu"
        n, itemsize = self.mesh.n_ranks, block.element_size()
        nbytes = (wire_bytes("all-gather", n * block.numel() * itemsize, n) if by_gather
                  else wire_bytes("all-reduce", math.prod(whole_shape) * itemsize, n))
        with self.mesh.collective("gather", nbytes):
            if by_gather:
                parts = [torch.empty_like(block) for _ in range(n)]
                dist.all_gather(parts, block.contiguous())
                whole = torch.empty(whole_shape, dtype=block.dtype, device=block.device)
                for rank, part in enumerate(parts):
                    whole[self.index(self.mesh.coordinates(rank), whole_shape)] = part
            else:
                whole = torch.zeros(whole_shape, dtype=block.dtype, device=block.device)
                coords = self.mesh.coordinates()
                if all(coords[a] == 0 for a in sizes if a not in named):
                    whole[self.index(coords, whole_shape)] = block
                    self._drop_copies(whole, coords)
                dist.all_reduce(whole)
        return whole

    def _drop_copies(self, whole: torch.Tensor, coords: dict) -> None:
        """Zero the whole segments of a :class:`Segments` dim in ``whole``
        unless this rank is at place 0 on the dim's axes (one copy of each
        enters :meth:`gather`'s sum)."""
        for d, entry in enumerate(self.spec):
            if not isinstance(entry, Segments) or self._place(entry, coords) == 0:
                continue
            lo, rows = 0, []
            for m, e in entry.parts:
                if self._ways(e) == 1:
                    rows += range(lo, lo + m)
                lo += m
            whole.index_fill_(d, torch.tensor(rows, device=whole.device), 0)


def to_shardings(pspecs, mesh):
    """Each spec of a spec tree as its :class:`Sharding` on ``mesh``."""
    return _map_specs(lambda s: Sharding(mesh, s), pspecs)


def cache_shardings(cache_struct, mesh):
    """The :class:`Sharding` of every tensor of a decode cache (whole
    shapes, meta or real) on ``mesh``: :func:`cache_pspecs`."""
    return to_shardings(cache_pspecs(cache_struct, mesh), mesh)


def _map_cache(fn, cache, shardings):
    """``fn(tensor, sharding)`` over a cache and its matching tree of
    Shardings, the cache's NamedTuple types and nesting kept."""
    if isinstance(cache, tuple):
        return type(cache)(*(_map_cache(fn, c, sh) for c, sh in zip(cache, shardings)))
    return fn(cache, shardings)


def cache_block(whole, mesh):
    """This rank's blocks of a whole decode cache: batch over the batch
    axes, an attention cache's sequence over "model" and an SSM state's
    heads over "model" (:func:`cache_pspecs`); ``pos`` stays whole."""
    return _map_cache(lambda x, sh: sh.block(x), whole, cache_shardings(whole, mesh))


def cache_gather(blocks, shardings):
    """The whole cache from every rank's ``blocks`` (``shardings``: the
    whole cache's, :func:`cache_shardings`), one gather a split tensor."""
    return _map_cache(lambda x, sh: sh.gather(x), blocks, shardings)


def leaves(tree) -> list:
    """The leaves of a tree of dicts (keys sorted), lists and tuples
    (NamedTuples too), ``None`` dropped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tensor_bytes(tree) -> int:
    """The bytes of every tensor in a tree of dicts, lists and tuples."""
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def sharded_bytes(structs, shardings) -> int:
    """One rank's bytes of a tree of tensors (meta or real, whole shapes)
    laid out by the matching tree of :class:`Sharding`."""
    return sum(math.prod(sh.block_shape(x.shape)) * x.element_size()
               for x, sh in zip(leaves(structs), leaves(shardings), strict=True))
