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
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device=device, dtype=dtype)


def params_from_jax(tree: dict, device, dtype: torch.dtype = torch.float32) -> dict:
    """JAX-layout parameter tree of array-likes (e.g. ``jax.tree.map(
    np.asarray, params)``, an ``init_params`` tree, or a loaded .npz tree)
    -> the port's tree of tensors on ``device``. Every leaf is floating and
    is cast to ``dtype``, norms, biases, ``rel_bias_table``, ``bn0`` and
    ``embed`` included, as the JAX wrapper casts every floating leaf to the
    compute dtype."""
    out = {k: _to_torch(v, device, dtype) for k, v in tree.items() if k != "decoder"}
    dec = tree["decoder"]
    stacked = dec["layers"]
    n_layers = len(next(iter(stacked.values())))
    decoder = {k: _to_torch(v, device, dtype) for k, v in dec.items() if k != "layers"}
    decoder["layers"] = [
        {k: _to_torch(np.asarray(v)[i], device, dtype) for k, v in stacked.items()}
        for i in range(n_layers)
    ]
    out["decoder"] = decoder
    return out


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return params.numel()
