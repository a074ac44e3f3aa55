"""Walks over the nested state the port keeps: tensors and numpy arrays
inside dataclasses, tuples, lists and dicts (a ``Preconditioner``'s state,
a ``SolveInfo``, a prepared matrix).  JAX flattens such state as a pytree;
here the walk is explicit."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _is_instance(obj) -> bool:
    return dataclasses.is_dataclass(obj) and not isinstance(obj, type)


def children(obj):
    """The (key, child) pairs of a container, or None for a leaf."""
    if _is_instance(obj):
        return [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj) if f.init]
    if isinstance(obj, (tuple, list)):
        return list(enumerate(obj))
    if isinstance(obj, dict):
        return list(obj.items())
    return None


def rebuild(obj, values: dict):
    """A copy of container ``obj`` with the children ``values`` (by key)."""
    if _is_instance(obj):
        return dataclasses.replace(obj, **values)
    if isinstance(obj, tuple):
        items = [values[i] for i in range(len(obj))]
        return type(obj)(*items) if hasattr(obj, "_fields") else type(obj)(items)
    if isinstance(obj, list):
        return [values[i] for i in range(len(obj))]
    return type(obj)(values)


def map_tensors(fn, tree, skip=()):
    """``tree`` with every tensor t replaced by ``fn(t)``; instances of the
    types in ``skip`` are kept whole."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if skip and isinstance(tree, skip):
        return tree
    kids = children(tree)
    if kids is None:
        return tree
    return rebuild(tree, {k: map_tensors(fn, v, skip) for k, v in kids})


def array_leaves(tree):
    """Every tensor and numpy array in ``tree``, depth first."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [tree]
    kids = children(tree)
    if kids is None:
        return []
    return [leaf for _, v in kids for leaf in array_leaves(v)]
