"""Checkpoint manager (port of ``repro.checkpoint.manager``): atomic,
async-capable, keep-N, with the JAX package's on-disk format, so either
package restores what the other wrote.

Layout:  <dir>/step_<k>/  { manifest.json, arr_<i>.npy ... }
  * leaves are copied to the host and written with a JSON manifest of the
    flattened tree paths, named as ``jax.tree_util.keystr`` names them
    (``['params']['embed']``; a NamedTuple field ``.m``), dict keys in
    sorted order, None an empty subtree;
  * types numpy cannot hold (bfloat16, float8) are stored as unsigned
    integers of the same width, with the logical type in the manifest;
  * writes go to ``<dir>/.tmp_step_<k>`` then ``os.rename``, so a crash
    mid-write never corrupts the latest checkpoint;
  * ``save(..., blocking=False)`` copies the leaves to the host first (the
    caller may update its tensors in place right after) and hands them to a
    writer thread;
  * data-pipeline state rides in the manifest, so a restore resumes the
    exact batch sequence;
  * checkpoints are mesh-agnostic (whole arrays): a trainer split over a
    mesh gathers its leaves before ``save``, and ``restore(...,
    shardings=, mesh=)`` hands each rank its slice, so a run may resume
    on another mesh (elastic resume).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

# numpy can't hold these torch types: store them as same-width uints
_UINT_VIEW = {1: (np.uint8, torch.uint8), 2: (np.uint16, torch.int16),
              4: (np.uint32, torch.int32)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: str = "") -> list[tuple[str, Any]]:
    """(keystr path, leaf) pairs in ``jax.tree.flatten_with_path``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{path}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten(x, f"{path}[{i}]")]
    return [(path, tree)]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from ``leaves``
    (an iterator, in :func:`_flatten`'s order)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    return next(leaves)


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(array to write, logical dtype name): always a copy, never a view of
    the leaf, so the caller may update its tensors in place while the
    writer thread holds the array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = str(t.dtype).removeprefix("torch.")
        try:
            np.dtype(name)
            return t.numpy(), name
        except TypeError:
            np_uint, torch_int = _UINT_VIEW[t.element_size()]
            return t.view(torch_int).numpy().view(np_uint), name
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _decode(arr: np.ndarray, logical: str) -> torch.Tensor:
    if str(arr.dtype) == logical:
        return torch.from_numpy(arr)
    _, torch_int = _UINT_VIEW[arr.dtype.itemsize]
    return torch.from_numpy(arr.view(np.dtype(str(torch_int).removeprefix(
        "torch.")))).view(getattr(torch, logical))


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ----- save -------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: dict | None = None,
             blocking: bool = True) -> None:
        self.wait()   # never two writers at once
        host = [(name, *_to_host(leaf)) for name, leaf in _flatten(tree)]
        if blocking:
            self._write(step, host, extra or {})
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: list, extra: dict) -> None:
        tmp = os.path.join(self.dir, f".tmp_step_{step:08d}")
        final = os.path.join(self.dir, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "arrays": []}
        for i, (name, arr, logical) in enumerate(host):
            fn = f"arr_{i:05d}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["arrays"].append(
                {"name": name, "file": fn, "shape": list(arr.shape),
                 "dtype": logical})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ----- restore ------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, shardings: Any | None = None,
                *, mesh=None) -> tuple[Any, dict]:
        """Restore into the structure of ``like`` (a tree of tensors or
        arrays of the whole shapes): each leaf comes back as a tensor of
        the ``like`` leaf's type on its device (the CPU for a meta tensor;
        an array of its type for an array).  ``shardings``: an optional
        tree of the same structure (a subtree may be None) whose leaves
        are placements tuples on ``mesh`` (``sharding.tree_shardings``'s);
        such a leaf comes back as this rank's slice (elastic resume)."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {a["name"]: a for a in manifest["arrays"]}
        places = dict(_flatten_places(shardings))
        if places and mesh is None:
            raise ValueError("restore(shardings=...) needs the mesh= they "
                             "are placements on")
        vals = []
        for name, leaf in _flatten(like):
            a = by_name[name]
            t = _decode(np.load(os.path.join(d, a["file"])), a["dtype"])
            expect = tuple(leaf.shape)
            if tuple(t.shape) != expect:
                raise ValueError(f"ckpt shape mismatch for {name}: "
                                 f"{tuple(t.shape)} vs {expect}")
            if name in places:
                from repro_torch.distributed.tensor_parallel import shard_of
                t = shard_of(t, mesh, places[name])
            if isinstance(leaf, torch.Tensor):
                dev = "cpu" if leaf.device.type == "meta" else leaf.device
                vals.append(t.to(device=dev, dtype=leaf.dtype))
            else:
                vals.append(t.numpy().astype(np.asarray(leaf).dtype))
        return _rebuild(like, iter(vals)), manifest["extra"]


def _is_placements(x) -> bool:
    from torch.distributed.tensor.placement_types import Placement
    return (isinstance(x, tuple) and not _is_namedtuple(x) and bool(x)
            and all(isinstance(p, Placement) for p in x))


def _flatten_places(tree, path: str = "") -> list[tuple[str, tuple]]:
    """(keystr path, placements) of a shardings tree, in :func:`_flatten`'s
    paths; a placements tuple is a leaf, None an empty subtree."""
    if tree is None:
        return []
    if _is_placements(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_places(tree[k], f"{path}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten_places(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten_places(x, f"{path}[{i}]")]
    raise TypeError(f"a shardings leaf at {path or 'the root'} is "
                    f"{type(tree).__name__}, not a placements tuple")
