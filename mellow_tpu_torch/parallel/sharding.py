"""The (data, model) mesh and the parameters' shards (``mellow_tpu/parallel/sharding.py``).

The JAX package annotates its arrays with ``NamedSharding`` and lets XLA
insert the collectives. The port runs one process per device over a
``torch.distributed.device_mesh.DeviceMesh`` of shape ``(dp, tp)`` with
dims ``("data", "model")``: global rank ``r`` sits at ``(r // tp, r % tp)``,
``mesh.get_group("model")`` holds the TP ranks of one data index and
``mesh.get_group("data")`` the DP ranks of one model index. Each rank keeps
explicit local shards of the parameters (plain tensors, which the kernels
take), sliced by ``mellow_param_specs``: JAX's spec tree in the port's
layout, where a spec is a tuple of ``None``/``"model"`` per axis.

  * ``data``: the batch's rows (DP);
  * ``model``: the decoder's MLP width, its vocabulary and, when the KV
    heads divide by the axis, its attention heads (TP). The audio encoder
    and a GPT-2 decoder stay replicated, as JAX's lookup gives them ``P()``.

The batch helpers (``data_rows``, ``gather_rows``) take the place of JAX's
``batch_sharding``: every rank holds the whole batch and takes its rows.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

AXES = ("data", "model")


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None):
    """The ``(data, model)`` mesh over every rank of the process group.

    ``tp`` defaults to 3 when 3 divides the world (v0's 3 KV heads), else 1
    (pure DP), as in the JAX package. Raises when the process group is not
    joined (``multihost.initialize``) or its world is not ``n_devices``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost.initialize() first")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a world of {n} ranks, not {world}")
    if tp is None:
        tp = 3 if n % 3 == 0 else 1
    if n % tp:
        raise ValueError(f"tp={tp} does not divide {n} devices")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, (n // tp, tp), mesh_dim_names=AXES)


def axis_sizes(mesh) -> dict:
    """{"data": dp, "model": tp} of a ``DeviceMesh`` (or of anything with a
    ``shape`` dict, as JAX's ``Mesh``)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_group(mesh):
    return mesh.get_group("data")


def data_index(mesh) -> int:
    """This rank's coordinate on the data axis."""
    return mesh.get_local_rank("data")


def data_rows(mesh, batch: int) -> slice:
    """This rank's rows of a batch of ``batch``: the data index's contiguous
    block. Raises where the data axis does not divide the batch."""
    dp = axis_sizes(mesh)["data"]
    if batch % dp:
        raise ValueError(f"batch {batch} not divisible by the data axis {dp}")
    n = batch // dp
    d = data_index(mesh)
    return slice(d * n, (d + 1) * n)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` (a mesh's data group) stacked on the
    leading axis, in rank order."""
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def data_generator(mesh, seed: int, device) -> torch.Generator:
    """The sampling generator of this rank's data index: the same on every
    rank of a model group (their logits are the same), another on each
    data index (JAX folds the device index into its key)."""
    g = torch.Generator(device=device)
    g.manual_seed((seed << 20) + data_index(mesh))
    return g


def _decoder_specs(heads_divisible: bool) -> dict:
    """Specs of the port's llama tree (per-layer dicts: JAX's leading L axis
    of the stacked layers drops out)."""
    attn = "model" if heads_divisible else None
    return {
        "embed": ("model", None),  # vocab-sharded; the head's logits are gathered
        "layers": {
            "ln_attn": (None,),
            "ln_mlp": (None,),
            "wq": (None, attn),
            "wk": (None, attn),
            "wv": (None, attn),
            "wo": (attn, None),
            "w_gate": (None, "model"),
            "w_up": (None, "model"),
            "w_down": ("model", None),
        },
        "norm_f": (None,),
        "lm_head": (None, "model"),
        "lm_head_q": (None, "model"),  # int8 weights: the vocab-sharded logits head
    }


def mellow_param_specs(params: dict, mesh, num_heads_kv: int = 3) -> dict:
    """The spec tree of ``params`` (same structure): the llama decoder
    TP-sharded, everything else replicated (``()``). An int8 ``{"q",
    "scale"}`` leaf takes JAX's rule: the values the float kernel's spec,
    the per-output-column scale that spec minus its contraction axis."""
    tp = axis_sizes(mesh)["model"]
    dec = _decoder_specs(num_heads_kv % tp == 0)

    def walk(tree, node):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if isinstance(node, dict) and k in node:
                    out[k] = walk(v, node[k])
                elif isinstance(node, tuple) and k == "q":
                    out[k] = walk(v, node)
                elif isinstance(node, tuple) and k == "scale":
                    out[k] = walk(v, node[:-2] + node[-1:] if len(node) >= 2 else ())
                else:
                    out[k] = walk(v, ())
            return out
        if isinstance(tree, (list, tuple)):  # the port's per-layer list
            return [walk(v, node) for v in tree]
        return node if isinstance(node, tuple) else ()

    return {k: walk(v, dec if k == "decoder" else ()) for k, v in params.items()}


def _map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def _axis(spec: tuple) -> Optional[int]:
    return spec.index("model") if "model" in spec else None


def _specs(params: dict, mesh, cfg) -> dict:
    """``mellow_param_specs`` of ``params`` under ``mesh`` at the KV-head
    count of ``cfg`` (a ``MellowConfig``): the llama decoder's; a GPT-2
    decoder's keys take no spec, so it stays replicated whatever the
    count."""
    return mellow_param_specs(params, mesh, getattr(cfg.decoder, "num_kv_heads", 1))


def shard_params(params: dict, mesh, cfg) -> dict:
    """The full tree of ``cfg`` -> this rank's shards: each sharded leaf's contiguous
    block ``mesh.get_local_rank("model")`` along its sharded axis (a copy,
    so the full tensor can be freed); replicated leaves as they are."""
    tp = axis_sizes(mesh)["model"]
    m = mesh.get_local_rank("model")

    def cut(x, spec):
        a = _axis(spec)
        if a is None or tp == 1:
            return x
        if x.shape[a] % tp:
            raise ValueError(f"a model axis of {tp} does not divide axis {a} of a {tuple(x.shape)} leaf")
        n = x.shape[a] // tp
        return x.narrow(a, m * n, n).contiguous().clone()

    return _map(cut, params, _specs(params, mesh, cfg))


def gather_params(params: dict, mesh, cfg) -> dict:
    """This rank's shards of ``cfg``'s tree -> the full tree (detached), all-gathered over the
    model group; collective: every rank calls it. For checkpoints and
    tests."""
    tp = axis_sizes(mesh)["model"]
    group = mesh.get_group("model")

    def join(x, spec):
        x = x.detach()
        a = _axis(spec)
        if a is None or tp == 1:
            return x
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(tp)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=a)

    return _map(join, params, _specs(params, mesh, cfg))


def sharded_leaves(params: dict, mesh, cfg) -> list:
    """For each leaf of ``params`` (``models.params.tree_leaves`` order),
    whether it is sharded over the model axis."""
    from mellow_tpu_torch.models.params import tree_leaves

    tp = axis_sizes(mesh)["model"]
    return tree_leaves(_map(lambda x, spec: tp > 1 and _axis(spec) is not None, params,
                            _specs(params, mesh, cfg)))


def decoder_tp(mesh, cfg):
    """The decoder's ``tensor.TP`` under ``mesh``: None on a pure-DP mesh and
    for a GPT-2 decoder (replicated: each rank runs the single-card path)."""
    from mellow_tpu_torch.parallel import tensor

    if cfg.decoder_family != "llama" or axis_sizes(mesh)["model"] == 1:
        return None
    return tensor.tp_of(mesh, cfg.decoder.num_kv_heads)
