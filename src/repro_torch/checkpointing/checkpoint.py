"""Checkpoint save/restore with a manifest and an atomic commit, in the JAX
package's on-disk format, so that a checkpoint written by either package
restores in the other.

Layout::

    <dir>/step_000123/
        manifest.json      # step, leaf index (path -> file, shape, dtype)
        leaf_00000.npy ... # one file per tree leaf
        COMMITTED          # written last: partial checkpoints are ignored

A tree is what the reference's pytrees are here: dicts (keys sorted; a key
may itself be a ``/``-joined path, ordered as the nested dicts it stands
for), lists and tuples, NamedTuples (a field is ``.name``), ``None`` (no
leaf), and tensor or numpy leaves.  Leaf paths are the reference's, letter
for letter: ``params/stack/attn/wq``, ``params/prefix/0/attn/wk``,
``opt/.step``, ``opt/.m/embed``, ``opt/.v/stack/moe/w_up/r``,
``hotness``.  bfloat16 leaves are saved as float32 (numpy has no
bfloat16), losslessly, and cast back on restore.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "cleanup_old"]

_COMMIT = "COMMITTED"


def _key(k) -> tuple:
    """Sort key of a dict key: the order of the nested dicts a path key
    stands for (list indices by number)."""
    return tuple(int(x) if x.isdigit() else x for x in str(k).split("/"))


def _children(node):
    """(name, child) pairs of an inner node in the reference's flatten
    order, or ``None`` for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node, key=_key)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    return None


def _paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs, as the reference's ``_paths`` gives them."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, child in kids:
        out += _paths(child, f"{prefix}/{name}" if prefix else name)
    return out


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        new = {k: None for k in like}
        for k in sorted(like, key=_key):
            new[k] = _rebuild(like[k], leaves)
        return new
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, leaves) for x in like)
    return next(leaves)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """The leaf as a numpy array numpy can save, and its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    dtype = str(arr.dtype)
    if arr.dtype.kind not in "fiub" or dtype == "bfloat16":
        arr = arr.astype(np.float32)
    return arr, dtype


def save(directory: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Atomically save a tree.  Returns the checkpoint path."""
    ckpt = os.path.join(directory, f"step_{step:09d}")
    tmp = ckpt + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "leaves": []}
    for i, (name, leaf) in enumerate(_paths(tree)):
        arr, dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"path": name, "file": fname, "shape": list(arr.shape),
             "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(ckpt):
        shutil.rmtree(ckpt)
    os.rename(tmp, ckpt)
    cleanup_old(directory, keep=keep)
    return ckpt


def _committed_steps(directory: str) -> List[int]:
    return sorted(
        int(d.split("_")[1]) for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(directory, d, _COMMIT)))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _committed_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, tree_like: Any, step: Optional[int] = None
            ) -> Tuple[Any, int]:
    """Restore into the structure of ``tree_like``, each leaf a tensor of
    its like's dtype on its like's device.  Returns (tree, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    ckpt = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(ckpt, "manifest.json")) as f:
        manifest = json.load(f)

    like_leaves = _paths(tree_like)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    missing = [n for n, _ in like_leaves if n not in by_path]
    if missing:
        raise ValueError(f"checkpoint missing leaves: {missing[:5]}...")

    leaves = []
    for name, like in like_leaves:
        arr = np.load(os.path.join(ckpt, by_path[name]["file"]))
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(
                f"shape mismatch for {name}: ckpt {arr.shape} vs "
                f"model {tuple(like.shape)}")
        leaves.append(torch.from_numpy(arr).to(device=like.device,
                                               dtype=like.dtype))
    return _rebuild(tree_like, iter(leaves)), step


def cleanup_old(directory: str, keep: int = 3) -> None:
    if not os.path.isdir(directory):
        return
    steps = _committed_steps(directory)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)
