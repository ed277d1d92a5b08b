"""Checkpoint manager: atomic commits, retention and asynchronous writes.
Port of ``repro/checkpoint/manager.py``, on the reference's file format.

* **Atomicity.** A step is written to ``<dir>/tmp.<step>/`` and renamed
  to ``step_<step:010d>/``; a crash mid-write never leaves a half
  checkpoint under a step's name (rename is atomic on POSIX).
* **Async.** ``save(..., blocking=False)`` copies every tensor to the
  host before it returns and hands the copies to a writer thread; an
  in-place update made after the call (the calibration step's AdamW)
  cannot reach the file. ``wait()`` blocks until the queue is on disk
  and re-raises a writer error.
* **Format.** One ``<name>.npz`` per named tree, leaves ``a0 .. aN`` in
  JAX's flatten order (dict keys sorted, ``AdamState`` as step, mu, nu,
  lists by index), and ``manifest.json`` with ``step`` and each tree's
  ``leaf_names`` spelled as the reference spells them (``.mu/a/x``); its
  ``treedef`` is this module's description of the structure. A bf16 leaf
  is stored as the reference stores one (raw ``|V2``, its bits) and read
  back by viewing them. So each package reads the other's files.
* **Restore.** ``like`` gives structure, dtypes and shapes; the leaves are
  placed on ``device``. The reference's ``shardings`` waits for the
  port's distributed slice.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Pytree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(path element, child) in JAX's flatten order, spelled as
    ``tree_flatten_with_path``'s keys print; None for a leaf."""
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def flatten_with_names(tree: Pytree, path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` in JAX's flatten order; ``None`` is an empty
    subtree, as in JAX."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [("/".join(path), tree)]
    return [item for key, child in kids for item in flatten_with_names(child, path + (key,))]


def describe(tree: Pytree) -> str:
    """The structure of ``tree`` with ``*`` for each leaf."""
    if tree is None:
        return "None"
    if _is_namedtuple(tree):
        return f"{type(tree).__name__}({', '.join(describe(v) for v in tree)})"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        open_, close = ("[", "]") if isinstance(tree, list) else ("(", ")")
        return open_ + ", ".join(describe(v) for v in tree) + close
    return "*"


def _rebuild(like: Pytree, take):
    """``like``'s structure, each leaf replaced by ``take(leaf)``, the
    leaves visited in JAX's flatten order (dicts keep ``like``'s order)."""
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), take) for f in like._fields))
    if isinstance(like, dict):
        vals = {k: _rebuild(like[k], take) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)([_rebuild(v, take) for v in like])
    return take(like)


def to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (tensor, array or number); bf16 as raw
    ``|V2`` bits, as ``np.savez`` writes the reference's bf16 arrays."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).to("cpu", copy=True).numpy().view(np.dtype("V2"))
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def from_host(arr: np.ndarray, like, device) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s dtype on ``device``; a ``|V2``
    array (a stored bf16 leaf) is read as bf16 bits."""
    arr = np.asarray(arr)
    if not isinstance(like, torch.Tensor):
        like = torch.from_numpy(np.asarray(like))
    want = like.dtype
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"stored shape {tuple(arr.shape)} is not {tuple(like.shape)}")
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2 or want != torch.bfloat16:
            raise ValueError(f"a {arr.dtype} leaf does not restore into {want}")
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device=device, dtype=want)


def as_manager(directory_or_manager, *, keep: int = 3) -> "CheckpointManager":
    """A ``CheckpointManager`` from a directory or a manager; ``keep``
    applies only when a new manager is made."""
    if isinstance(directory_or_manager, CheckpointManager):
        return directory_or_manager
    return CheckpointManager(str(directory_or_manager), keep=keep)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, trees: Dict[str, Pytree], *, blocking: bool = True) -> None:
        """Save named trees for ``step``. Every leaf is copied to the host
        before this returns, with ``blocking`` or without."""
        host = {name: [(n, to_host(leaf)) for n, leaf in flatten_with_names(tree)]
                for name, tree in trees.items()}
        shapes = {name: describe(tree) for name, tree in trees.items()}
        if blocking:
            self._write(step, host, shapes)
        else:
            self._ensure_worker()
            self._queue.put((step, host, shapes))

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _drain(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            try:
                self._write(*item)
            except Exception as e:  # surfaced by the next wait()
                self._error = e

    def wait(self):
        """Block until queued saves are on disk; re-raise a writer error."""
        if self._worker is not None and self._worker.is_alive():
            self._queue.put(None)
            self._worker.join()
            self._worker = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _write(self, step: int, host: Dict[str, List[Tuple[str, np.ndarray]]],
               shapes: Dict[str, str]):
        tmp = os.path.join(self.directory, f"tmp.{step}")
        final = self.step_dir(step)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "trees": {}}
        for name, named in host.items():
            np.savez(os.path.join(tmp, f"{name}.npz"),
                     **{f"a{i}": arr for i, (_, arr) in enumerate(named)})
            manifest["trees"][name] = {"leaf_names": [n for n, _ in named],
                                       "treedef": shapes[name]}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self.step_dir(s))

    # -- restore ------------------------------------------------------------

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_steps(self) -> List[int]:
        return sorted(int(d[len("step_"):]) for d in os.listdir(self.directory)
                      if d.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def leaf_names(self, step: int, name: str) -> List[str]:
        """The manifest's leaf names of tree ``name`` at ``step``."""
        with open(os.path.join(self.step_dir(step), "manifest.json")) as f:
            return json.load(f)["trees"][name]["leaf_names"]

    def restore(self, step: int, like: Dict[str, Pytree], *,
                device="cuda") -> Dict[str, Pytree]:
        """Named trees of ``like``'s structure, dtypes and shapes, their
        leaves read from ``step`` and placed on ``device``. Raises when a
        stored leaf's name or shape differs from ``like``'s."""
        device = torch.device(device)
        out = {}
        for name, ref_tree in like.items():
            names = [n for n, _ in flatten_with_names(ref_tree)]
            stored = self.leaf_names(step, name)
            if stored != names:
                raise ValueError(f"tree {name!r} at step {step} holds leaves {stored}, "
                                 f"not {names}")
            with np.load(os.path.join(self.step_dir(step), f"{name}.npz")) as data:
                arrays = iter([data[f"a{i}"] for i in range(len(names))])
                out[name] = _rebuild(ref_tree, lambda leaf: from_host(next(arrays), leaf,
                                                                      device))
        return out
