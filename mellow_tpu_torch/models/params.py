"""Parameter trees: the JAX package's layout -> the port's.

The trees are the same except for the decoder, whose JAX form stacks every
per-layer leaf on a leading L axis (``mellow_tpu/models/llama.py``); the
port keeps a list of per-layer dicts.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_torch(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device, dtype) for v in tree]
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.integer):  # int8 weights keep their type
        return torch.from_numpy(np.array(a)).to(device)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dtype)


def _layer(tree, i: int):
    """Layer ``i`` of a tree whose leaves are stacked on a leading L axis."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_jax(tree: dict, device, dtype: torch.dtype = torch.float32) -> dict:
    """JAX-layout parameter tree of array-likes (e.g. ``jax.tree.map(
    np.asarray, params)``, an ``init_params`` tree, or a loaded .npz tree)
    -> the port's tree of tensors on ``device``. Every floating leaf is cast
    to ``dtype``, norms, biases, ``rel_bias_table``, ``bn0`` and ``embed``
    included, as the JAX wrapper casts every floating leaf to the compute
    dtype; integer leaves (the int8 values of a quantized decoder) keep
    their type."""
    out = {k: _to_torch(v, device, dtype) for k, v in tree.items() if k != "decoder"}
    dec = tree["decoder"]
    stacked = dec["layers"]
    first = next(iter(stacked.values()))
    n_layers = len(np.asarray(first["q"] if isinstance(first, dict) else first))
    decoder = {k: _to_torch(v, device, dtype) for k, v in dec.items() if k != "layers"}
    decoder["layers"] = [_to_torch(_layer(stacked, i), device, dtype) for i in range(n_layers)]
    out["decoder"] = decoder
    return out


def cast_floating(tree, dtype: torch.dtype):
    """Every floating tensor of a tree cast to ``dtype``; others unchanged."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_floating(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return params.numel()


def tree_leaves(tree) -> list:
    """The tensors of a tree (dicts by sorted key, lists in order), in a
    fixed order: the order of ``flatten``'s keys."""
    return list(flatten(tree).values())


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def flatten(tree, prefix: str = "") -> dict:
    """{"decoder/layers/0/wq": tensor, ...}: every leaf under its path,
    dicts by sorted key."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in flatten(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in flatten(x, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def unflatten(flat: dict, template, prefix: str = ""):
    """The tree of ``template``'s structure whose leaves are ``flat``'s (a
    ``flatten`` of a tree of that structure)."""
    if isinstance(template, dict):
        return {k: unflatten(flat, v, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [unflatten(flat, v, f"{prefix}{i}/") for i, v in enumerate(template)]
    return flat[prefix[:-1]]
