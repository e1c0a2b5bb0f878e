"""Checkpoints with atomic commit, in the reference's file layout (port of
``repro/checkpoint/manager.py``).

Layout, the reference's to the byte of every leaf:

    <dir>/step_00000123.tmp/...   (written first)
    <dir>/step_00000123/          (atomic rename = commit)
        manifest.json             (tree structure, shapes, dtypes)
        arrays.npz                (leaf_i: the tree's leaves as host numpy)
        extra.json                (optional caller metadata)

Leaves are numbered in JAX's ``jax.tree.flatten`` order, which this module
reproduces without JAX: dict keys sorted, lists and tuples in order,
``None`` dropped (an empty subtree).  A tree saved by either package
restores in the other: the state dicts of both name and type their leaves
alike (``convert.py``), so leaf i is the same array on both sides.
Tensors are written as host numpy arrays of their own dtype (a uint32
``salt`` stays uint32 on disk).

Durability: ``save`` writes every file, fsyncs each and the ``.tmp``
directory, renames it into place, then fsyncs the parent so the rename
itself is durable -- a host crash never surfaces a committed directory with
a torn ``arrays.npz``.  ``fsync_file`` / ``fsync_dir`` are public for the
shard tier's write-ahead log, which commits with the same sequence.
Readers see only committed directories: ``latest_step`` skips ``.tmp``.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch


def fsync_file(path: str | Path) -> None:
    """Flush one file's data and metadata to stable storage."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str | Path) -> None:
    """Flush a directory's entries (creations and renames in it) to disk."""
    fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _flatten(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _flatten(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _flatten(item)]
    return [tree]


def _treedef(tree) -> str:
    """The structure as JAX prints a treedef's body: ``{'a': *, 'b': *}``."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{key!r}: {_treedef(tree[key])}"
                               for key in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(item) for item in tree) + "]"
    if isinstance(tree, tuple):
        body = ", ".join(_treedef(item) for item in tree)
        return f"({body},)" if len(tree) == 1 else f"({body})"
    return "*"


def _unflatten(example, leaves):
    """``example``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if example is None:
        return None
    if isinstance(example, dict):
        # fill in sorted-key order, keep the example's key order
        filled = {key: _unflatten(example[key], leaves) for key in sorted(example)}
        return {key: filled[key] for key in example}
    if isinstance(example, (list, tuple)):
        return type(example)(_unflatten(item, leaves) for item in example)
    return next(leaves)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(ckpt_dir: str | Path, step: int, tree, *, extra: dict | None = None,
         keep_last: int = 3, fsync: bool = True) -> Path:
    """Commit ``tree`` (nested dicts, lists, tuples of tensors or arrays) as
    ``step``; keep the newest ``keep_last`` committed steps."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    host = [_host(x) for x in _flatten(tree)]
    np.savez(tmp / "arrays.npz", **{f"leaf_{i}": a for i, a in enumerate(host)})
    manifest = {
        "step": step,
        "treedef": f"PyTreeDef({_treedef(tree)})",
        "n_leaves": len(host),
        "shapes": [list(a.shape) for a in host],
        "dtypes": [str(a.dtype) for a in host],
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if extra is not None:
        (tmp / "extra.json").write_text(json.dumps(extra))
    if fsync:
        # every byte on stable storage BEFORE the rename makes it visible
        for p in sorted(tmp.iterdir()):
            fsync_file(p)
        fsync_dir(tmp)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit: readers never see a partial step
    if fsync:
        fsync_dir(ckpt_dir)  # the rename itself

    steps = sorted(p for p in ckpt_dir.iterdir()
                   if p.is_dir() and not p.name.endswith(".tmp"))
    for p in steps[:-keep_last]:
        shutil.rmtree(p)
    return final


def latest_step(ckpt_dir: str | Path) -> int | None:
    """The newest committed step under ``ckpt_dir`` (``None`` if none)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
             if p.is_dir() and p.name.startswith("step_")
             and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str | Path, step: int, example_tree):
    """The committed ``step`` in the structure of ``example_tree``, leaves as
    host numpy arrays (a state dict's ``load_state_dict`` takes them)."""
    path = Path(ckpt_dir) / f"step_{step:08d}"
    flat = _flatten(example_tree)
    with np.load(path / "arrays.npz") as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(flat))]
    for got, want in zip(leaves, flat):
        if hasattr(want, "shape") and tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch: ckpt {got.shape} vs model {tuple(want.shape)}")
    return _unflatten(example_tree, iter(leaves))


def restore_slice(ckpt_dir: str | Path, step: int, example_tree, index: int):
    """Restore ONE row of a stacked checkpoint into a single-instance tree.

    A multi-tenant bank (``stats.service.MultiTenantStats``) saves its
    state as [T, ...]-stacked leaves named like the single sampler's.
    ``example_tree`` is the single-instance structure (e.g. a
    ``MultiSampler.state_dict()``); each stored leaf is matched with the
    example's leaf at its position:

    * equal shape                       -> shared, kept whole;
    * one more dim, equal trailing dims -> stacked, sliced at ``[index]``;
    * anything else                     -> error (incompatible checkpoint).

    The tenant handoff: one tenant out of a bank checkpoint into a
    standalone service.
    """
    path = Path(ckpt_dir) / f"step_{step:08d}"
    flat = _flatten(example_tree)
    n_stored = json.loads((path / "manifest.json").read_text())["n_leaves"]
    if n_stored != len(flat):
        raise ValueError(
            f"leaf count mismatch: checkpoint has {n_stored}, example tree "
            f"has {len(flat)} -- the example must be the single-instance "
            "form of the stacked state (same keys, minus the stack axis)")
    out = []
    with np.load(path / "arrays.npz") as data:
        for i, want in enumerate(flat):
            got = data[f"leaf_{i}"]
            wshape = tuple(want.shape) if hasattr(want, "shape") else np.shape(want)
            if tuple(got.shape) == wshape:
                out.append(got)
            elif got.ndim == len(wshape) + 1 and tuple(got.shape[1:]) == wshape:
                if not 0 <= index < got.shape[0]:
                    raise IndexError(
                        f"slice index {index} out of range for stacked leaf_{i} "
                        f"with {got.shape[0]} instances")
                out.append(got[index])
            else:
                raise ValueError(
                    f"leaf_{i}: ckpt shape {got.shape} is neither shared "
                    f"({wshape}) nor stacked ((T,)+{wshape})")
    return _unflatten(example_tree, iter(out))


def restore_extra(ckpt_dir: str | Path, step: int) -> dict:
    """The caller metadata saved with ``step`` (``{}`` when there was none)."""
    p = Path(ckpt_dir) / f"step_{step:08d}" / "extra.json"
    return json.loads(p.read_text()) if p.exists() else {}
