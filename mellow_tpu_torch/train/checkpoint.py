"""Checkpoint save and resume for training (``mellow_tpu/train/checkpoint.py``),
as one ``step_{n}.pt`` file a step: a flat dict of tensors written with
``torch.save`` and read back with ``torch.load(weights_only=True)``, so
loading runs no pickled code. The JAX package writes Orbax directories (or
an .npz); ``latest`` finds either name the same way.

Under a mesh the file holds the full trees, gathered from the model
group's shards and written by rank 0, so it is the unsharded run's format;
``restore`` slices it for this rank, so a checkpoint from any mesh resumes
on any mesh."""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from mellow_tpu_torch.models.params import flatten, unflatten
from mellow_tpu_torch.parallel import sharding
from mellow_tpu_torch.train.step import OptState, TrainState


def save(ckpt_dir: str, state: TrainState, mesh=None, cfg=None) -> str:
    """Write ``state`` to ``ckpt_dir/step_{state.step}.pt``; returns the path.
    Keys: ``params/...``, ``mu/...``, ``nu/...`` (the trees' paths),
    ``count`` and ``step``. Written to a temporary name and renamed, so a
    reader never sees half a file. Under ``mesh`` (collective: every rank
    calls it, with the run's ``MellowConfig`` ``cfg``) the trees are
    gathered from their shards, rank 0 writes, and every rank returns once
    the file is there."""
    _need_cfg(mesh, cfg)
    trees = (("params", state.params), ("mu", state.opt_state.mu), ("nu", state.opt_state.nu))
    if mesh is not None:
        trees = [(name, sharding.gather_params(tree, mesh, cfg)) for name, tree in trees]
    path = os.path.join(ckpt_dir, f"step_{state.step}.pt")
    if mesh is None or dist.get_rank() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        flat = {"count": torch.tensor(state.opt_state.count), "step": torch.tensor(state.step)}
        for name, tree in trees:
            flat.update({f"{name}/{k}": v.detach().cpu() for k, v in flatten(tree).items()})
        tmp = os.path.join(ckpt_dir, f".step_{state.step}.pt.tmp")  # not a name ``latest`` takes
        torch.save(flat, tmp)
        os.replace(tmp, path)
    if mesh is not None:
        dist.barrier()
    return path


def restore(path: str, template: TrainState, mesh=None, cfg=None) -> TrainState:
    """The state saved at ``path``, its tensors on the devices and in the
    dtypes of ``template``'s (which gives the trees' structure); under
    ``mesh`` (with the run's ``MellowConfig`` ``cfg``), this rank's shards
    of it (``template`` holds shards)."""
    _need_cfg(mesh, cfg)
    flat = torch.load(path, map_location="cpu", weights_only=True)

    def tree(name, like, grad=False):
        sub = {k[len(name) + 1:]: v for k, v in flat.items() if k.startswith(name + "/")}
        ref = flatten(like)
        if sorted(sub) != sorted(ref):
            raise ValueError(f"{path}: {name} does not match the template's tree")
        out = unflatten({k: sub[k].to(device=t.device, dtype=t.dtype) for k, t in ref.items()}, like)
        if mesh is not None:
            out = sharding.shard_params(out, mesh, cfg)
        return unflatten({k: t.requires_grad_(grad) for k, t in flatten(out).items()}, like)

    opt = OptState(tree("mu", template.opt_state.mu), tree("nu", template.opt_state.nu), int(flat["count"]))
    return TrainState(tree("params", template.params, grad=True), opt, int(flat["step"]))


def _need_cfg(mesh, cfg) -> None:
    if mesh is not None and cfg is None:
        raise ValueError("a sharded state needs its MellowConfig (cfg=) to find its shards")


def latest(ckpt_dir: str) -> Optional[str]:
    """The checkpoint of the highest step in ``ckpt_dir`` (``step_{n}`` with
    any suffix), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    entries = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                step = int(name.split("_")[1].split(".")[0])
            except ValueError:
                continue
            entries.append((step, os.path.join(ckpt_dir, name)))
    return max(entries)[1] if entries else None
