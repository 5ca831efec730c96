"""The training loop (``mellow_tpu/train/loop.py``): batches -> train steps
-> metrics -> periodic checkpoints, with resume."""

from __future__ import annotations

import time
from typing import Optional

import torch

from mellow_tpu_torch.config import MellowConfig
from mellow_tpu_torch.models.params import tree_leaves, tree_map
from mellow_tpu_torch.train import checkpoint as ckpt
from mellow_tpu_torch.train import step as step_mod
from mellow_tpu_torch.train.data import ReasonAQALoader
from mellow_tpu_torch.utils.metrics import GLOBAL as metrics


def step_generator(seed: int, step: int, device):
    """The generator of step ``step``: seeded from (seed, step) alone, so a
    resumed run draws what an uninterrupted one would (the JAX loop folds
    the step into its key)."""
    g = torch.Generator(device=device)
    g.manual_seed((seed << 32) + step)
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
    ``ckpt_every`` steps and one at the end. Returns the final state."""
    if mesh is not None:
        raise NotImplementedError("mesh (sharded training) is not ported")
    optimizer = step_mod.make_optimizer(learning_rate=learning_rate)
    state = step_mod.init_train_state(tree_map(lambda p: p.detach().clone(), params), optimizer)
    device = tree_leaves(state.params)[0].device

    if resume and ckpt_dir:
        latest = ckpt.latest(ckpt_dir)
        if latest:
            state = ckpt.restore(latest, state)
            print(f"[train] resumed from {latest} (step {state.step})")

    step_count = state.step
    t_last = time.time()
    for epoch in range(num_epochs):
        for batch in loader.epoch(epoch):
            if max_steps is not None and step_count >= max_steps:
                return state
            with metrics.timer("train_step"):
                state, m = step_mod.train_step_accum(
                    state, cfg, optimizer, batch, step_generator(seed, step_count, device),
                    accum_steps=accum_steps, remat=remat, mixup=mixup,
                )
                n_tokens = float(m["num_answer_tokens"])  # waits for the step
            step_count += 1
            metrics.count("train_steps", 1)
            metrics.count("answer_tokens", n_tokens)
            if step_count % log_every == 0:
                dt = time.time() - t_last
                t_last = time.time()
                print(
                    f"[train] step {step_count} loss {float(m['loss']):.4f} "
                    f"acc {float(m['accuracy']):.3f} "
                    f"gnorm {float(m['grad_norm']):.2f} "
                    f"({log_every / dt:.2f} steps/s)"
                )
            if ckpt_dir and step_count % ckpt_every == 0:
                path = ckpt.save(ckpt_dir, state)
                print(f"[train] checkpoint -> {path}")
    if ckpt_dir:
        ckpt.save(ckpt_dir, state)
    return state
