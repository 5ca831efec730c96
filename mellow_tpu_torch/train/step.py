"""Training step in PyTorch (``mellow_tpu/train/step.py``): the loss and its
gradients by autograd, then one AdamW update written to optax's semantics.

The objective is ``models/mellow.forward_train`` (next-token cross entropy
over the answer tokens, the prefix masked). The optimizer is the JAX
package's ``optax.chain(clip_by_global_norm(max_grad_norm),
adamw(warmup_cosine_decay_schedule(0, lr, warmup, total), weight_decay))``,
not ``torch.optim``'s defaults, which differ from it in three places:

  * the learning rate of update k (k = 0, 1, ...) is the schedule at k, so
    the first update moves nothing (its moments still count it);
  * the gradients are scaled by ``max_norm / norm`` only when ``norm >=
    max_norm``, with no epsilon;
  * the decoupled decay ``weight_decay * param`` is added to Adam's
    direction and the sum scaled by ``-lr``: the decay reads the parameter
    from before the update.

The state's tensors are updated in place, as the JAX step donates its
state: the ``TrainState`` returned holds the same parameter tensors as the
one given. ``clone_state`` copies one.

Under a mesh (``mesh=``, a ``parallel.sharding.make_mesh``), where the JAX
step leaves the collectives to XLA: every rank is given the whole batch
and takes its data index's rows; the loss is the global batch's token mean
(``forward_train``'s ``data_group``); the gradients, this rank's shares,
are summed over the data group in one flat buffer per dtype; the global
norm counts each sharded leaf's shards once (their squares summed over the
model group) and each replicated leaf once; AdamW updates the local shards.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from mellow_tpu_torch.config import MellowConfig
from mellow_tpu_torch.models import mellow as mellow_model
from mellow_tpu_torch.models.params import tree_leaves, tree_map
from mellow_tpu_torch.parallel import sharding


class OptState(NamedTuple):
    mu: dict  # first moments, the parameters' tree
    nu: dict  # second moments
    count: int  # updates applied


class TrainState(NamedTuple):
    params: dict  # the port's tree of tensors
    opt_state: OptState
    step: int


@dataclass(frozen=True)
class AdamW:
    """Clip by global norm, then AdamW with a linear warmup from 0 and a
    cosine decay to 0 (optax's ``warmup_cosine_decay_schedule``)."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 10_000
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def schedule(self, count: int) -> float:
        """The learning rate of update ``count`` (0-based)."""
        if count < self.warmup_steps:
            return self.learning_rate * count / self.warmup_steps
        decay_steps = self.total_steps - self.warmup_steps
        t = min(count - self.warmup_steps, decay_steps)
        return self.learning_rate * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))

    def init(self, params: dict) -> OptState:
        return OptState(mu=tree_map(torch.zeros_like, params), nu=tree_map(torch.zeros_like, params), count=0)

    @torch.no_grad()
    def apply(self, params: dict, grads: List[torch.Tensor], state: OptState,
              norm: Optional[torch.Tensor] = None) -> OptState:
        """One update of ``params`` in place from ``grads`` (in the order of
        ``tree_leaves(params)``); returns the new optimizer state, whose
        moments are the old state's tensors updated in place. ``norm``: the
        gradients' global norm, where a mesh computes it (default:
        ``global_norm(grads)``)."""
        ps, mus, nus = tree_leaves(params), tree_leaves(state.mu), tree_leaves(state.nu)
        if norm is None:
            norm = global_norm(grads)
        keep = norm < self.max_grad_norm  # on the device: no host sync
        grads = [torch.where(keep, g, g / norm * self.max_grad_norm) for g in grads]
        count = state.count + 1
        c1, c2 = 1.0 - self.b1 ** count, 1.0 - self.b2 ** count
        lr = self.schedule(state.count)
        for p, g, mu, nu in zip(ps, grads, mus, nus):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            direction = (mu / c1) / ((nu / c2).sqrt() + self.eps) + self.weight_decay * p
            p.add_(direction, alpha=-lr)
        return state._replace(count=count)


def make_optimizer(
    learning_rate: float = 1e-4,
    weight_decay: float = 0.01,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    max_grad_norm: float = 1.0,
) -> AdamW:
    return AdamW(learning_rate, weight_decay, warmup_steps, total_steps, max_grad_norm)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of every element squared), in fp32 (``optax.global_norm``)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def sharded_global_norm(tensors: List[torch.Tensor], sharded: List[bool], group) -> torch.Tensor:
    """``global_norm`` of a tree whose leaves flagged in ``sharded`` are
    this rank's shards over ``group``: their squares are summed over the
    group, every other leaf (the same on each rank) counted once."""
    squares = sum(((t.float() ** 2).sum() for t, s in zip(tensors, sharded) if not s),
                  torch.zeros((), dtype=torch.float32, device=tensors[0].device))
    if any(sharded):
        own = sum((t.float() ** 2).sum() for t, s in zip(tensors, sharded) if s)
        dist.all_reduce(own, group=group)
        squares = squares + own
    return torch.sqrt(squares)


def _sum_over(grads: List[torch.Tensor], group) -> List[torch.Tensor]:
    """``grads`` summed over ``group``, one flat buffer per dtype."""
    out = list(grads)
    for dtype in sorted({g.dtype for g in grads}, key=str):
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, chunk in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = chunk.view_as(grads[i])
    return out


class _Mesh(NamedTuple):
    """A train step's view of the mesh: this rank's rows of a batch of B,
    the decoder's TP (None for pure DP and for a replicated GPT-2), the
    data group, and which leaves are sharded."""

    mesh: object
    tp: object
    data_group: object
    sharded: List[bool]


def _mesh_view(mesh, cfg: MellowConfig, params: dict) -> Optional[_Mesh]:
    if mesh is None:
        return None
    return _Mesh(mesh, sharding.decoder_tp(mesh, cfg), sharding.data_group(mesh),
                 sharding.sharded_leaves(params, mesh, cfg))


def init_train_state(params: dict, optimizer: AdamW) -> TrainState:
    """A state over ``params`` (the port's tree; each leaf made a leaf that
    requires grad) with zero moments at step 0."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    return TrainState(params, optimizer.init(params), 0)


def clone_state(state: TrainState) -> TrainState:
    """A copy of ``state`` that shares no tensor with it."""
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True), state.params)
    mu, nu = (tree_map(lambda t: t.clone(), m) for m in (state.opt_state.mu, state.opt_state.nu))
    return TrainState(params, OptState(mu, nu, state.opt_state.count), state.step)


def _device_batch(batch: dict, params: dict) -> dict:
    """The batch's arrays on the parameters' device, the audio in their
    dtype (the wrapper's compute dtype)."""
    ref = tree_leaves(params)[0]
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v).to(ref.device)
        out[k] = v.to(ref.dtype) if k in ("audio1", "audio2") else v
    return out


def _loss_and_grads(state: TrainState, cfg: MellowConfig, mb: dict, rng, remat: bool,
                    mixup: bool, mv: Optional[_Mesh] = None) -> Tuple[dict, List[torch.Tensor]]:
    """The metrics and gradients of ``mb`` (under a mesh: this rank's rows,
    the metrics the global micro-batch's, the gradients this rank's
    share)."""
    mixup_lambda = None
    if mixup:
        if rng is None:
            raise ValueError("mixup draws its weights from rng; pass a torch.Generator")
        B = mb["audio1"].shape[0]
        if B % 2:
            raise ValueError(f"mixup pairs rows 2i and 2i+1; a batch of {B} rows (this rank's) is odd")
        from mellow_tpu_torch.train.augment import sample_mixup_lambda

        mixup_lambda = sample_mixup_lambda(rng, B)
    loss, metrics = mellow_model.forward_train(
        state.params, cfg, mb["audio1"], mb["audio2"], mb["text_ids"], mb["answer_ids"], mb["answer_mask"],
        rng=rng, remat=remat, mixup_lambda=mixup_lambda,
        **({} if mv is None else {"tp": mv.tp, "data_group": mv.data_group}))
    leaves = tree_leaves(state.params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # A leaf the loss never reads (TSCAM's clip head) has a zero gradient, as in JAX.
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return {k: v.detach() for k, v in metrics.items()}, grads


def train_step(
    state: TrainState,
    cfg: MellowConfig,
    optimizer: AdamW,
    batch: dict,  # audio1, audio2, text_ids, answer_ids, answer_mask
    rng: Optional[torch.Generator],
    remat: bool = False,
    mixup: bool = False,
    mesh=None,
) -> Tuple[TrainState, dict]:
    """One step: loss and gradients on the batch, one optimizer update.
    ``rng`` (a generator on the parameters' device) drives the encoder's
    SpecAugment, drop-path and dropout and, with ``mixup``, the mixup
    weights; None turns the stochastic paths off. Returns the state and
    the metrics (``loss``, ``num_answer_tokens``, ``accuracy``,
    ``grad_norm``; 0-d tensors). ``mesh``: ``state`` holds this rank's
    shards, ``batch`` is the global batch, ``rng`` this data index's
    (``loop.step_generator``); collective, every rank calls it."""
    return train_step_accum(state, cfg, optimizer, batch, rng, 1, remat=remat, mixup=mixup, mesh=mesh)


def _update(state: TrainState, optimizer: AdamW, grads: List[torch.Tensor], metrics: dict,
            mv: Optional[_Mesh]) -> Tuple[TrainState, dict]:
    """Sum the gradients over the data group (under a mesh), take their
    global norm and apply one update."""
    if mv is None:
        norm = global_norm(grads)
    else:
        grads = _sum_over(grads, mv.data_group)
        norm = sharded_global_norm(grads, mv.sharded, mv.mesh.get_group("model"))
    metrics["grad_norm"] = norm
    opt_state = optimizer.apply(state.params, grads, state.opt_state, norm=norm)
    return TrainState(state.params, opt_state, state.step + 1), metrics


def train_step_accum(
    state: TrainState,
    cfg: MellowConfig,
    optimizer: AdamW,
    batch: dict,  # leading batch axis divisible by accum_steps
    rng: Optional[torch.Generator],
    accum_steps: int,
    remat: bool = False,
    mixup: bool = False,
    mesh=None,
) -> Tuple[TrainState, dict]:
    """``train_step`` with gradient accumulation: the batch split into
    ``accum_steps`` micro-batches run in turn (activation memory is a
    micro-batch's), their gradients averaged, then one optimizer update.
    The loss and accuracy are averaged weighted by each micro-batch's
    answer tokens, so the metrics are the whole batch's. Under ``mesh``
    each micro-batch is the unsharded run's, and this rank takes its rows
    of it."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be at least 1, got {accum_steps}")
    mv = _mesh_view(mesh, cfg, state.params)
    batch = _device_batch(batch, state.params)
    B = batch["audio1"].shape[0]
    if B % accum_steps:
        raise ValueError(f"batch {B} is not divisible by accum_steps {accum_steps}")
    mb_size = B // accum_steps
    if accum_steps == 1:
        mb = batch if mv is None else _rows(batch, mv, 0, B)
        metrics, grads = _loss_and_grads(state, cfg, mb, rng, remat, mixup, mv)
        return _update(state, optimizer, grads, metrics, mv)
    grads, loss_sum, acc_sum, ntok = None, 0.0, 0.0, 0.0
    for i in range(accum_steps):
        if mv is None:
            mb = {k: v[i * mb_size : (i + 1) * mb_size] for k, v in batch.items()}
        else:
            mb = _rows(batch, mv, i * mb_size, mb_size)
        m, g = _loss_and_grads(state, cfg, mb, rng, remat, mixup, mv)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        n = m["num_answer_tokens"].float()
        loss_sum, acc_sum, ntok = loss_sum + m["loss"] * n, acc_sum + m["accuracy"] * n, ntok + n
    grads = [g / accum_steps for g in grads]
    metrics = {"loss": loss_sum / ntok.clamp_min(1.0), "accuracy": acc_sum / ntok.clamp_min(1.0),
               "num_answer_tokens": ntok}
    return _update(state, optimizer, grads, metrics, mv)


def _rows(batch: dict, mv: _Mesh, start: int, size: int) -> dict:
    """This rank's rows of the micro-batch ``[start, start + size)``."""
    rows = sharding.data_rows(mv.mesh, size)
    return {k: v[start + rows.start : start + rows.stop] for k, v in batch.items()}
