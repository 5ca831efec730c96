"""The training loop (``mellow_tpu/train/loop.py``): batches -> train steps
-> metrics -> periodic checkpoints, with resume.

Under a mesh every rank runs this loop over the same loader (so the rows
are the unsharded run's), each taking its data index's rows of a batch;
rank 0 logs and writes the checkpoints."""

from __future__ import annotations

import time
from typing import Optional

import torch

from mellow_tpu_torch.config import MellowConfig
from mellow_tpu_torch.models.params import tree_leaves, tree_map
from mellow_tpu_torch.parallel import multihost, sharding
from mellow_tpu_torch.train import checkpoint as ckpt
from mellow_tpu_torch.train import step as step_mod
from mellow_tpu_torch.train.data import ReasonAQALoader
from mellow_tpu_torch.utils.metrics import GLOBAL as metrics


def step_generator(seed: int, step: int, device, data_index: int = 0):
    """The generator of step ``step``: seeded from (seed, step) alone, so a
    resumed run draws what an uninterrupted one would (the JAX loop folds
    the step into its key). Under a mesh, from (seed, step, data index): the
    TP ranks of one data index draw the same SpecAugment, drop-path and
    dropout for their shared rows; data index 0 draws the unsharded run's
    stream."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed << 32) + step + (data_index << 48)) % (1 << 64))
    return g


def train(
    params: dict,
    cfg: MellowConfig,
    loader: ReasonAQALoader,
    *,
    num_epochs: int = 1,
    max_steps: Optional[int] = None,
    learning_rate: float = 1e-4,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 500,
    resume: bool = True,
    mesh=None,
    log_every: int = 20,
    seed: int = 0,
    remat: bool = False,
    mixup: bool = False,  # the reference's train-time mixup (htsat.py:871-874)
    accum_steps: int = 1,  # gradient accumulation over micro-batches
) -> step_mod.TrainState:
    """Train ``params`` (the port's tree of tensors, e.g. a wrapper's
    ``params``; copied, never changed) on ``loader``'s batches for
    ``num_epochs`` epochs or ``max_steps`` steps, resuming from the latest
    checkpoint in ``ckpt_dir`` when ``resume``, saving one every
    ``ckpt_every`` steps and one at the end. Returns the final state.

    ``mesh`` (``parallel.sharding.make_mesh``; collective, every rank calls
    it with the full ``params``): the state holds this rank's shards, each
    step takes this data index's rows and draws, and the checkpoints hold
    the full trees (``checkpoint.save``)."""
    optimizer = step_mod.make_optimizer(learning_rate=learning_rate)
    params = tree_map(lambda p: p.detach().clone(), params)
    data_index, primary = 0, True
    if mesh is not None:
        data_index, primary = sharding.data_index(mesh), multihost.is_primary()
        params = sharding.shard_params(params, mesh, cfg)
    state = step_mod.init_train_state(params, optimizer)
    device = tree_leaves(state.params)[0].device

    if resume and ckpt_dir:
        latest = ckpt.latest(ckpt_dir)
        if latest:
            state = ckpt.restore(latest, state, mesh, cfg)
            if primary:
                print(f"[train] resumed from {latest} (step {state.step})")

    step_count = state.step
    t_last = time.time()
    for epoch in range(num_epochs):
        for batch in loader.epoch(epoch):
            if max_steps is not None and step_count >= max_steps:
                return state
            with metrics.timer("train_step"):
                state, m = step_mod.train_step_accum(
                    state, cfg, optimizer, batch, step_generator(seed, step_count, device, data_index),
                    accum_steps=accum_steps, remat=remat, mixup=mixup, mesh=mesh,
                )
                n_tokens = float(m["num_answer_tokens"])  # waits for the step
            step_count += 1
            metrics.count("train_steps", 1)
            metrics.count("answer_tokens", n_tokens)
            if step_count % log_every == 0 and primary:
                dt = time.time() - t_last
                t_last = time.time()
                print(
                    f"[train] step {step_count} loss {float(m['loss']):.4f} "
                    f"acc {float(m['accuracy']):.3f} "
                    f"gnorm {float(m['grad_norm']):.2f} "
                    f"({log_every / dt:.2f} steps/s)"
                )
            if ckpt_dir and step_count % ckpt_every == 0:
                path = ckpt.save(ckpt_dir, state, mesh, cfg)
                if primary:
                    print(f"[train] checkpoint -> {path}")
    if ckpt_dir:
        ckpt.save(ckpt_dir, state, mesh, cfg)
    return state
