"""Param-tree (de)serialization: nested dict/list trees <-> flat .npz.

Runtime-side (torch-free). tools/convert_ckpt.py uses these to persist
converted checkpoints; the wrapper uses them to load."""

from __future__ import annotations

from typing import Dict

import numpy as np


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}[{i}]/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("[") and k.endswith("]") for k in node):
            return [listify(node[f"[{i}]"]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_params(params, path: str) -> None:
    np.savez(path, **flatten_tree(params))


def load_params(path: str):
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})
