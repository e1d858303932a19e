"""npz checkpointing of tensor trees (port of ``repro.checkpoint.npz``).

Flat key scheme, the reference's: a tree's leaf paths are serialized as
'/'-joined strings of dict keys (sorted, as ``jax.tree_util`` orders them),
NamedTuple field names and sequence indices; ``None`` is an empty subtree
and writes nothing. A tree of the same structure therefore gives the same
npz keys in both packages, and an npz written by either loads in the other
through numpy. Tensors leave through ``.detach().cpu().numpy()``; a
bfloat16 leaf, which numpy has no type for, is written as its 2-byte bits
(``|V2``), as numpy writes the reference's ml_dtypes bfloat16 leaves.
:func:`load_pytree` places each leaf on the template leaf's device and
dtype.

Writes are CRASH-ATOMIC: the npz is fully written (and fsynced) to a tmp
file in the target directory, the ``.meta.json`` sidecar is published
first, and only then is the npz renamed into place with ``os.replace`` —
the npz is the COMMIT POINT. A process killed mid-save can therefore never
leave a torn npz at the published path (``sim.resilience`` discovers
checkpoints by npz presence, so a visible checkpoint always has both a
complete npz and its metadata), and a truncated file written by any other
means fails ``load_pytree`` loudly instead of half-reading.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch


def _paths(path: str) -> tuple[str, str]:
    """Normalize ``path`` (with or without the ``.npz`` suffix) to the
    published ``(npz_path, meta_path)`` pair — one rule for save and
    restore, so the sidecar is always found where it was written."""
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".npz", base + ".meta.json"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves_with_paths(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf)]`` of ``tree`` in ``jax.tree_util``'s order: dict keys
    sorted, NamedTuple fields and sequence items in order, ``None`` no
    leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_with_paths(tree[k], prefix + (k,))]
    if _is_namedtuple(tree):
        return [x for f, v in zip(tree._fields, tree)
                for x in leaves_with_paths(v, prefix + (f,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves_with_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def map_with_paths(fn, tree, prefix: tuple = ()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)`` (structure
    kept, ``None`` kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, prefix + (k,)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_paths(fn, v, prefix + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, v, prefix + (i,)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    return np.asarray(leaf)


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A stored array as a tensor; ``|V2`` leaves are bfloat16 bits."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_pytree(path: str, tree, metadata: Optional[dict] = None) -> None:
    """Atomically persist ``tree`` (and optional ``metadata``) at ``path``.

    Write order is the crash-safety contract: (1) the full npz streams into
    a same-directory tmp file and is fsynced, (2) the ``.meta.json`` sidecar
    is atomically published, (3) ``os.replace`` commits the npz. A kill at
    any point leaves either no published npz (steps 1-2: at worst a stale
    ``*.tmp-<pid>`` file and an orphan sidecar, both harmless) or a complete
    checkpoint — never a torn npz under the published name.
    """
    flat = {_key(p): _to_numpy(leaf) for p, leaf in leaves_with_paths(tree)}
    npz_path, meta_path = _paths(path)
    os.makedirs(os.path.dirname(os.path.abspath(npz_path)), exist_ok=True)
    tmp = f"{npz_path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        if metadata is not None:
            meta_tmp = f"{meta_path}.tmp-{os.getpid()}"
            with open(meta_tmp, "w") as f:
                json.dump(metadata, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(meta_tmp, meta_path)
        os.replace(tmp, npz_path)
    except BaseException:
        # never leave the tmp behind on a failed save (a crash can — it is
        # ignored by discovery either way)
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def load_pytree(path: str, template) -> Any:
    """Restore into the structure of ``template``: a tensor leaf comes back
    as a tensor on the template leaf's device and dtype, any other leaf as
    the numpy array."""
    with np.load(_paths(path)[0]) as data:

        def leaf(p, like):
            arr = data[_key(p)]
            if isinstance(like, torch.Tensor):
                return _to_tensor(arr).to(device=like.device, dtype=like.dtype)
            return arr

        return map_with_paths(leaf, template)


def save(path: str, step: int, params, opt_state=None, extra: Optional[dict] = None):
    """Save a full training state."""
    state = {"params": params}
    if opt_state is not None:
        state["opt_state"] = opt_state
    save_pytree(path, state, metadata={"step": step, **(extra or {})})


def restore(path: str, params_template, opt_template=None):
    """Returns (step, params, opt_state)."""
    state_t = {"params": params_template}
    if opt_template is not None:
        state_t["opt_state"] = opt_template
    state = load_pytree(path, state_t)
    meta_path = _paths(path)[1]
    step = 0
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            step = json.load(f).get("step", 0)
    return step, state["params"], state.get("opt_state")
