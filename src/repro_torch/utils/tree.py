"""Pytree utilities over nested dicts (and lists) of tensors.

A tree is what the reference's parameter, optimizer and gradient pytrees are:
dicts and lists nesting tensors, a layer stack held as one leaf of shape
``(n_layers, ...)``. Leaves come in JAX's order — dict keys sorted, lists in
order, ``None`` an empty subtree — so a flattened gradient is the reference's
vector element for element, and the compressor's 2^14-value chunks, which
straddle leaf boundaries, get the reference's masks. Leaf names are
``jax.tree_util.keystr``'s (``['params']['layers']['attn']['wq']``), the keys
of a checkpoint.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

import torch


def _items(node) -> Iterator[tuple[str, Any]]:
    if isinstance(node, dict):
        for k in sorted(node):
            yield f"[{k!r}]", node[k]
    else:
        for i, v in enumerate(node):
            yield f"[{i}]", v


def tree_leaves_with_path(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(keystr, leaf), ...]`` in JAX's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, (dict, list, tuple)):
        out = []
        for name, v in _items(tree):
            out += tree_leaves_with_path(v, prefix + name)
        return out
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``,
    rebuilt in ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path_names(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """``fn(name, leaf)`` over the leaves of ``tree``, where name is the
    '/'-joined key path (``layers/attn/wq``; the sharding rules' names)."""

    def go(node, parts):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: go(v, parts + [str(k)]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(go(v, parts + [str(i)]) for i, v in enumerate(node))
        return fn("/".join(parts), node)

    return go(tree, [])


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in JAX's order)."""
    by_name = dict(zip((name for name, _ in tree_leaves_with_path(like)), leaves))

    def build(node, prefix):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k], f"{prefix}[{k!r}]") for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, f"{prefix}[{i}]") for i, v in enumerate(node))
        return by_name[prefix]

    return build(like, "")


def tree_size_bytes(tree: Any) -> int:
    """Total bytes across all tensor leaves."""
    return sum(l.numel() * l.element_size() for l in tree_leaves(tree) if torch.is_tensor(l))


def tree_count_params(tree: Any) -> int:
    return sum(l.numel() for l in tree_leaves(tree) if torch.is_tensor(l))


def tree_global_norm(tree: Any) -> torch.Tensor:
    """Global ℓ2 norm, each leaf's sum of squares accumulated in float32."""
    sq = [torch.dot(l.reshape(-1).float(), l.reshape(-1).float()) for l in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def tree_flatten_to_vector(tree: Any, length: int | None = None
                           ) -> tuple[torch.Tensor, Callable[[torch.Tensor], Any]]:
    """Flatten all leaves into one float32 vector; returns (vector, unflatten).

    The paper's estimator acts on vectors in R^p, so the gradient tree is
    viewed as one long vector, zero-padded to ``length`` if given.
    ``unflatten`` takes such a vector (its first values) and gives each leaf
    its shape and dtype back.
    """
    leaves = tree_leaves(tree)
    shapes = [l.shape for l in leaves]
    dtypes = [l.dtype for l in leaves]
    sizes = [l.numel() for l in leaves]
    total = sum(sizes)
    device = leaves[0].device if leaves else None
    vec = torch.zeros((total if length is None else length,), dtype=torch.float32, device=device)
    off = 0
    for l, size in zip(leaves, sizes):
        vec[off:off + size] = l.reshape(-1)
        off += size

    def unflatten(v: torch.Tensor) -> Any:
        out, off = [], 0
        for shape, dtype, size in zip(shapes, dtypes, sizes):
            out.append(v[off:off + size].reshape(shape).to(dtype))
            off += size
        return tree_unflatten(tree, out)

    return vec, unflatten
