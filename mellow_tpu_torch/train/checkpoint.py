"""Checkpoint save and resume for training (``mellow_tpu/train/checkpoint.py``),
as one ``step_{n}.pt`` file a step: a flat dict of tensors written with
``torch.save`` and read back with ``torch.load(weights_only=True)``, so
loading runs no pickled code. The JAX package writes Orbax directories (or
an .npz); ``latest`` finds either name the same way."""

from __future__ import annotations

import os
from typing import Optional

import torch

from mellow_tpu_torch.models.params import flatten, unflatten
from mellow_tpu_torch.train.step import OptState, TrainState


def save(ckpt_dir: str, state: TrainState) -> str:
    """Write ``state`` to ``ckpt_dir/step_{state.step}.pt``; returns the path.
    Keys: ``params/...``, ``mu/...``, ``nu/...`` (the trees' paths),
    ``count`` and ``step``. Written to a temporary name and renamed, so a
    reader never sees half a file."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {"count": torch.tensor(state.opt_state.count), "step": torch.tensor(state.step)}
    for name, tree in (("params", state.params), ("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        flat.update({f"{name}/{k}": v.detach().cpu() for k, v in flatten(tree).items()})
    path = os.path.join(ckpt_dir, f"step_{state.step}.pt")
    tmp = os.path.join(ckpt_dir, f".step_{state.step}.pt.tmp")  # not a name ``latest`` takes
    torch.save(flat, tmp)
    os.replace(tmp, path)
    return path


def restore(path: str, template: TrainState) -> TrainState:
    """The state saved at ``path``, its tensors on the devices and in the
    dtypes of ``template``'s (which gives the trees' structure)."""
    flat = torch.load(path, map_location="cpu", weights_only=True)

    def tree(name, like, grad=False):
        sub = {k[len(name) + 1:]: v for k, v in flat.items() if k.startswith(name + "/")}
        ref = flatten(like)
        if sorted(sub) != sorted(ref):
            raise ValueError(f"{path}: {name} does not match the template's tree")
        out = {k: sub[k].to(device=t.device, dtype=t.dtype).requires_grad_(grad) for k, t in ref.items()}
        return unflatten(out, like)

    opt = OptState(tree("mu", template.opt_state.mu), tree("nu", template.opt_state.nu), int(flat["count"]))
    return TrainState(tree("params", template.params, grad=True), opt, int(flat["step"]))


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
