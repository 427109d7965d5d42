"""Divisibility-aware sharding resolver, as the JAX package resolves it.

Model code declares *preferred* mesh axes per tensor dimension (an "axes
tree" mirroring the parameter tree).  This module resolves preferences to
concrete specs against a mesh, dropping any axis that does not evenly
divide its dimension (qwen3's 40 heads against model=16: the head
sharding is dropped while d_ff=17408 shards cleanly) and never using a
mesh axis twice in one spec.

``expand_data=True`` maps the logical 'data' axis to ('pod', 'data'): for
batch, activation and cache trees on the multi-pod mesh, while parameters
keep FSDP confined to one pod.

A spec is a plain tuple with one entry per tensor dimension: a mesh axis
name, a tuple of names (sharded over their product, the first the major
one) or None.  A mesh is a ``DeviceMesh``, or its ``{axis: size}`` mapping
where no process group exists (an abstract mesh: the resolver reads only
the sizes).  :func:`placements` turns a spec into DTensor placements.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

Spec = Tuple[Optional[object], ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a DeviceMesh, or the mapping itself."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's placement: ``spec`` on ``mesh``."""

    mesh: object
    spec: Spec


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and len(x) > 0 and all(
        y is None or isinstance(y, str) or (
            isinstance(y, tuple) and all(isinstance(z, str) for z in y)
        )
        for y in x
    )


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of nested dicts, lists and tuples (``rest``
    shaped like ``tree``); ``is_leaf`` stops the descent.  None is an
    empty subtree."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        return type(tree)(out) if not hasattr(tree, "_fields") \
            else type(tree)(*out)
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf=None) -> list:
    """The leaves of nested dicts, lists and tuples, dicts in sorted key
    order (the JAX package's flattening order)."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v, is_leaf)]
    return [tree]


def resolve_pspec(pref: Tuple, shape: Tuple[int, ...], mesh,
                  expand_data: bool = False) -> Spec:
    sizes = axis_sizes(mesh)
    used = set()
    resolved = []
    pref = tuple(pref) + (None,) * (len(shape) - len(pref))
    for dim, ax in zip(shape, pref):
        if ax is None:
            resolved.append(None)
            continue
        names = list(ax) if isinstance(ax, tuple) else [ax]
        if expand_data and "data" in names and "pod" in sizes:
            names = ["pod" if n == "data" else n for n in names] + ["data"]
            # ('pod','data') acts as the combined DP axis
            seen = set()
            names = [n for n in names if not (n in seen or seen.add(n))]
        names = [n for n in names if n in sizes and n not in used]
        total = int(np.prod([sizes[n] for n in names])) if names else 1
        if names and dim % total == 0 and dim > 0:
            resolved.append(tuple(names) if len(names) > 1 else names[0])
            used.update(names)
        else:
            # try each axis individually before giving up
            placed = False
            for n in names:
                if dim % sizes[n] == 0:
                    resolved.append(n)
                    used.add(n)
                    placed = True
                    break
            if not placed:
                resolved.append(None)
    return tuple(resolved)


def tree_shardings(axes_tree, shape_tree, mesh, expand_data: bool = False):
    """A NamedSharding for each leaf of ``shape_tree`` (anything with a
    ``shape``), given its axes-preferences tree."""

    def mk(ax, leaf):
        return NamedSharding(
            mesh, resolve_pspec(ax, tuple(leaf.shape), mesh,
                                expand_data=expand_data))

    return tree_map(mk, axes_tree, shape_tree, is_leaf=_is_axes_leaf)


def sharded_bytes_per_device(shape_tree, sharding_tree) -> int:
    """Analytic per-device bytes for a sharded tree (dry-run reporting);
    leaves have a ``shape`` and a torch ``dtype``."""
    total = 0
    shardings = tree_leaves(sharding_tree,
                            is_leaf=lambda x: isinstance(x, NamedSharding))
    for leaf, sh in zip(tree_leaves(shape_tree), shardings):
        shape = tuple(leaf.shape)
        n = int(np.prod(shape)) if shape else 1
        sizes = axis_sizes(sh.mesh)
        div = 1
        for dim, ax in zip(shape, tuple(sh.spec) + (None,) * len(shape)):
            if ax is None:
                continue
            names = ax if isinstance(ax, tuple) else (ax,)
            for nm in names:
                div *= sizes[nm]
        total += n * leaf.dtype.itemsize // max(div, 1)
    return total


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on a DeviceMesh: ``Shard(d)`` on
    each mesh dimension that shards tensor dimension d, ``Replicate()``
    on the rest.  A tuple entry shards its dimension over its axes with
    the first the major one, which DTensor expresses only when they come
    in the mesh's order."""
    # imported here: it takes about a second, and the models import this
    # module for tree_map
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {tuple(names)}")
        for m in dims:
            out[m] = Shard(d)
    return tuple(out)
