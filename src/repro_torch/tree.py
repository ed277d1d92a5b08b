"""Walks over the port's parameter trees: nested dicts and lists whose
leaves are tensors or the dataclass leaves ``CrossbarWeight`` and
``PreparedCrossbar``. This is what ``jax.tree_util`` does for ``repro``;
paths are spelled the way ``repro.core.calibrate._path_str`` spells
them ("body/0/mixer/q/w"), so per-leaf seeds derive from the same
strings."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence

import torch


def map_with_path(fn: Callable, tree, is_leaf: Callable = lambda v: False,
                  path: tuple = ()):
    """``fn(path, leaf)`` over every leaf; ``path`` is a tuple of str."""
    if is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, is_leaf, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, is_leaf, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def path_str(path: Sequence[str]) -> str:
    return "/".join(path)


def map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """``fn`` over every tensor, including the tensor fields of dataclass
    leaves (their int/tuple fields are kept)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)
        })
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tensors(fn, v) for v in tree]
    return tree


def tensors(tree) -> List[torch.Tensor]:
    """Every tensor of ``tree`` in walk order."""
    out: List[torch.Tensor] = []
    map_tensors(lambda t: out.append(t) or t, tree)
    return out


def stack(trees: Sequence[Any]):
    """Stack same-structured trees leaf by leaf on a new axis 0 (the
    scan-group stacking ``repro`` does with ``jnp.stack``)."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(list(trees))
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: stack([getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(first)
            if isinstance(getattr(first, f.name), torch.Tensor)
        })
    if isinstance(first, dict):
        return {k: stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [stack([t[i] for t in trees]) for i in range(len(first))]
    return first


def index(tree, i: int):
    """Layer ``i`` of a stacked tree: views, no copies."""
    return map_tensors(lambda t: t[i], tree)
