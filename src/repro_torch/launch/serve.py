"""Batched serving: prefill once, decode greedily.

Port of ``repro.launch.serve``. On one card (every family) the mesh
becomes a device and the sharded, donated serve step a Python loop over
:func:`repro_torch.models.api.model_decode`, which updates the cache (KV,
SSM state, a hybrid's pair of them, an enc-dec decoder's self-attention
part) in place. ``load_params`` casts the fp32 parameters to the serving
type once, except the leaves the reference reads in fp32
(``FP32_LEAVES``); the reference casts the others inside every step: the
same values. A VLM's prompt is its patch embeddings ("embeds") then its
tokens, an enc-dec model's its frame embeddings ("frames") and the
decoder's tokens.

The decode loop never waits on the host: each greedy token is an ``argmax``
on the card fed to the next step, and the caller reads all of them at once
(the reference reads every token to the host as it goes; the tokens are the
same). The prefill runs in the ``serve.prefill`` range, the decode loop in
``serve.decode``.

Over a (data, model) mesh of ranks (a ``RankMesh`` where one card takes a
device; a dense or SSM model on any mesh, a MoE model over data ranks:
``launch.steps.check_rank_serving``) each rank serves its rows of the batch
(``batch_pspecs``) and holds its blocks of their cache (``cache_pspecs``: a
dense model's KV cache split by sequence over "model", its positions
whole; an SSM model's state by heads and its conv window by channels). A MoE model routes each rank's rows in the whole batch's routing
groups over the data ranks (``launch.steps.moe_group``,
``models.layers.moe_fwd``), so its drops are one process's. Over M > 1
model ranks a dense model is split tensor-parallel: each rank holds its
TP blocks of the weights (``sharding.tp_pspecs``: its heads, its MLP
columns, its vocabulary block) and computes its share of every product,
the group summing the row-split ones; the prefill re-lays each layer's k
and v of its heads into its cache block, a decode step gathers the new
token's heads and combines the attention over the group (flash-decoding,
``models.layers.attention_decode``), and the greedy token combines the
vocabulary blocks (``models.layers.greedy``). An SSM model over M > 1
model ranks is split by SSM heads the same way: each rank runs kernel 4
on its nh/M heads, the group summing the mixer norm's statistic and
``out_proj``'s rows, and gathering the conv window's channels in the
prefill and in every decode step (``models.layers.mamba2_fwd``,
``mamba2_decode``).
:meth:`Server.gather_logits` makes vocabulary blocks of logits whole over
"model", :meth:`Server.gather_tokens` the whole batch's tokens over
"data".
"""
from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import RankMesh
from repro_torch.launch.sharding import FP32_LEAVES, Sharding, _batched, to_shardings
from repro_torch.launch.steps import (
    _param_specs, _serving_params, check_rank_serving, model_group, moe_group, params_structs,
    row_ways,
)
from repro_torch.models import api
from repro_torch.models.cache import cache_to
from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models.layers import check_ported, greedy


class Server:
    """Serves ``cfg`` in ``dtype``; ``shape`` is the capacity it is built for
    (at most ``shape.global_batch`` sequences, positions below
    ``shape.seq_len``). ``device``: a device (the card unless the caller
    names another), or a ``RankMesh`` to serve over its ranks, each rank
    on its own device with its rows and cache blocks (module docstring)."""

    def __init__(self, cfg: ModelConfig, shape: InputShape, device=None,
                 dtype=torch.bfloat16):
        check_ported(cfg)
        self.cfg, self.shape, self.dtype = cfg, shape, dtype
        self.mesh = device if isinstance(device, RankMesh) else None
        if self.mesh is None:
            self.device, self.group, self.data, self.row_ways = (resolve_device(device), None,
                                                                 None, 1)
            return
        check_rank_serving(cfg, self.mesh)
        self.cuts = _serving_params(cfg, shape, self.mesh)  # raises where M does not divide
        self.device = self.mesh.device
        self.group = model_group(self.mesh)
        self.data = moe_group(cfg, self.mesh, shape.global_batch)
        self.row_ways = row_ways(self.mesh, shape.global_batch)
        self._rows = _batched(shape.global_batch, self.mesh)

    def load_params(self, params):
        """The parameters on the device, fp32 leaves cast to ``dtype`` once
        (but ``FP32_LEAVES``). Over ranks each rank gets its TP blocks
        (``sharding.tp_pspecs``; with one model rank, the whole weights),
        given the whole weights or this rank's blocks by ``params_pspecs``
        (as the rank trainer holds its masters), one leaf at a time: a
        leaf's blocks are gathered whole, cut and the whole copy dropped,
        so a whole leaf exists on a rank only while it is cut."""
        if self.mesh is None:
            return self._load(params)
        specs = to_shardings(_param_specs(self.cfg, self.shape, self.mesh), self.mesh)
        return self._load(params, params_structs(self.cfg), specs, self.cuts)

    def _load(self, node, struct=None, specs=None, cuts=None, key=""):
        """One leaf (or a dict of them, recursively) as :meth:`load_params`
        loads it: its whole leaf's shape (``struct``), its spec block's
        Sharding (``specs``) and its TP block's (``cuts``) beside it."""
        if isinstance(node, dict):
            def pick(tree, k):
                return None if tree is None else tree[k]
            return {k: self._load(node[k], pick(struct, k), pick(specs, k), pick(cuts, k), k)
                    for k in node}
        if cuts is not None:
            if tuple(node.shape) != tuple(struct.shape):
                if tuple(node.shape) != specs.block_shape(struct.shape):
                    raise ValueError(f"a parameter of shape {tuple(node.shape)} is neither "
                                     f"whole {tuple(struct.shape)} nor this rank's block of it")
                node = specs.gather(node.to(self.device))
            node = cuts.block(node)
        cast = node.dtype == torch.float32 and key not in FP32_LEAVES
        return node.to(self.device, self.dtype if cast else node.dtype)

    def _check_capacity(self, batch: int, last_t: int) -> None:
        """``batch`` rows a rank (the whole batch's are ``row_ways`` times
        as many) up to position ``last_t``, against the global shape."""
        batch *= self.row_ways
        if batch > self.shape.global_batch or last_t >= self.shape.seq_len:
            raise ValueError(
                f"batch {batch} / position {last_t} beyond the server's shape "
                f"{self.shape.name} ({self.shape.global_batch} × {self.shape.seq_len})")

    def batch_block(self, batch: dict) -> dict:
        """This rank's rows of a whole batch (each tensor's first dim by
        ``batch_pspecs``); on one device the batch itself."""
        if self.mesh is None:
            return batch
        return {k: Sharding(self.mesh, (self._rows,) + (None,) * (v.dim() - 1)).block(v)
                for k, v in batch.items()}

    def prefill(self, params, batch: dict, pad_to: int | None = None):
        """Run the prompt: "tokens", and a VLM's "embeds" or an enc-dec
        model's "frames" → (first greedy token (B, 1), last-position logits
        (B, 1, vocab_padded), cache). A VLM's patches take the first
        positions of the cache, so they count against its capacity.
        ``pad_to``: grow the cache to that many slots (``pad_cache``).
        Over ranks ``batch`` is this rank's rows, the cache its blocks and
        the logits, over model ranks, its vocabulary block
        (:meth:`gather_logits`; ``launch.steps.build_prefill_step``)."""
        inputs = {k: batch[k].to(self.device) for k in ("tokens", "embeds", "frames")
                  if k in batch}
        tokens = inputs["tokens"]
        n_patches = inputs["embeds"].shape[1] if "embeds" in inputs else 0
        self._check_capacity(tokens.shape[0], n_patches + tokens.shape[1] - 1)
        with record_function("serve.prefill"):
            logits, cache = api.model_prefill(params, self.cfg, inputs, self.dtype,
                                              group=self.group, pad_to=pad_to, data=self.data)
            first = greedy(logits[:, -1], self.group)
        return first, logits, cache

    def decode(self, params, first_token, cache, start_t: int, n_tokens: int,
               keep_logits: bool = False):
        """Greedy decode ``n_tokens`` tokens from a prefilled cache → (tokens
        (B, n_tokens) on the device, cache), and with ``keep_logits`` each
        step's last-position logits (B, n_tokens − 1, vocab_padded) besides.
        The first token is ``first_token``; step i feeds token i at position
        ``start_t + i``. The cache is updated in place once it is on the
        device. Over ranks: this rank's rows and cache blocks, and over
        model ranks the logits' vocabulary block (:meth:`gather_logits`)."""
        tok = first_token.to(self.device)
        self._check_capacity(tok.shape[0], start_t + n_tokens - 2)
        cache = cache_to(cache, self.device)
        toks, kept = [tok], []
        with record_function("serve.decode"):
            for i in range(n_tokens - 1):
                logits, cache = api.model_decode(params, self.cfg, tok, cache, start_t + i,
                                                 self.dtype, group=self.group, data=self.data)
                tok = greedy(logits[:, -1], self.group)
                toks.append(tok)
                if keep_logits:
                    kept.append(logits[:, -1])
        if keep_logits:
            return torch.cat(toks, dim=1), cache, torch.stack(kept, dim=1)
        return torch.cat(toks, dim=1), cache

    def gather_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Whole-vocabulary logits from this rank's vocabulary block of them
        (last dim; a gather over the model group, counted as
        ``ranks.gather``); on one device, or with one model rank a group,
        ``logits`` itself."""
        return logits if self.group is None else self.group.all_gather(logits, -1)

    def gather_tokens(self, toks: torch.Tensor) -> torch.Tensor:
        """The whole batch's tokens from every rank's rows (a gather over
        the ranks, counted as ``ranks.gather``); on one device, or where
        every rank holds every row, ``toks`` itself."""
        if self.mesh is None:
            return toks
        return Sharding(self.mesh, (self._rows, None)).gather(toks)


def serve_demo(cfg: ModelConfig, batch: dict, n_tokens: int = 16,
               dtype=torch.bfloat16, seed: int = 0, device=None,
               shape_name: str = "decode_32k"):
    """End-to-end: init params → prefill → batched greedy decode.

    As in the reference, the decode continues from the *unpadded* prefill
    cache, so in a dense, vlm or moe model, in a hybrid's shared block and
    in an enc-dec decoder's self-attention, from the first new token on slot
    ``t % S`` overwrites the oldest prompt slot: the decode attends over a
    sliding window of the prompt's length (``pad_cache`` first, as
    ``examples/serve_decode.py`` does, for full attention). An SSM state
    needs no padding. Also as in the reference, the decode starts at ``t =
    tokens.shape[1]``, which leaves a VLM's patches out: its first new token
    takes a position inside the prompt, its slot overwrites a prompt slot
    and ``cache_pos <= t`` hides every later prompt position from it
    (``Server.decode`` takes ``start_t = n_patches + tokens`` for the
    positions the prompt took). ``device``: a device, or a ``RankMesh``:
    every rank draws the same weights, serves its rows of ``batch`` (the
    whole batch) and gets the whole batch's tokens. Returns (tokens (B,
    n_tokens) on the CPU, timings in seconds).
    """
    server = Server(cfg, INPUT_SHAPES[shape_name], device, dtype)
    dev = server.device
    params = server.load_params(api.model_init(cfg, seed, dev))
    _sync(dev)
    t0 = time.perf_counter()
    first, _, cache = server.prefill(params, server.batch_block(batch))
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    toks, _ = server.decode(params, first, cache, start_t=batch["tokens"].shape[1],
                            n_tokens=n_tokens)
    toks = server.gather_tokens(toks).cpu()
    t_decode = time.perf_counter() - t0
    return toks, {"prefill_s": t_prefill, "decode_s": t_decode,
                  "tok_per_s": n_tokens * toks.shape[0] / max(t_decode, 1e-9)}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
