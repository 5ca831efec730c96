"""Training-time augmentations in PyTorch (``mellow_tpu/train/augment.py``):
SpecAugment's stripe drops and mixup.

Every draw comes from an explicit ``torch.Generator`` on the tensor's
device, so the draws differ from the JAX package's key streams; what is
kept is the distribution. Shapes stay fixed: stripes are applied as masks,
never by slicing.
"""

from __future__ import annotations

import torch


def _drop_stripes(x: torch.Tensor, rng: torch.Generator, axis: int, drop_width: int,
                  stripes_num: int) -> torch.Tensor:
    """Zero ``stripes_num`` random stripes of width U[0, drop_width) along
    ``axis``, each starting at U[0, max(dim - width, 1)), independently per
    batch row (torchlibrosa's DropStripes)."""
    B, dim = x.shape[0], x.shape[axis]
    idx = torch.arange(dim, device=x.device)
    mask = torch.ones((B, dim), dtype=torch.bool, device=x.device)
    for _ in range(stripes_num):
        width = torch.randint(0, drop_width, (B, 1), generator=rng, device=x.device)
        high = (dim - width).clamp_min(1)
        start = (torch.rand((B, 1), generator=rng, device=x.device) * high).long().minimum(high - 1)
        mask &= ~((idx >= start) & (idx < start + width))
    shape = [1] * x.ndim
    shape[0], shape[axis] = B, dim
    return x * mask.reshape(shape).to(x.dtype)


def spec_augment(
    x: torch.Tensor,  # (B, T, F) log-mel
    rng: torch.Generator,
    time_drop_width: int = 64,
    time_stripes_num: int = 2,
    freq_drop_width: int = 8,
    freq_stripes_num: int = 2,
) -> torch.Tensor:
    """The reference's SpecAugmentation(64, 2, 8, 2): stripes along time,
    then along the mel bins."""
    x = _drop_stripes(x, rng, axis=1, drop_width=time_drop_width, stripes_num=time_stripes_num)
    return _drop_stripes(x, rng, axis=2, drop_width=freq_drop_width, stripes_num=freq_stripes_num)


def mixup(x: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Mix even rows with odd rows: out[i] = x[2i] * lam[2i] + x[2i+1] *
    lam[2i+1]; halves the batch."""
    shape = (-1,) + (1,) * (x.ndim - 1)
    return x[0::2] * lam[0::2].reshape(shape) + x[1::2] * lam[1::2].reshape(shape)


def sample_mixup_lambda(rng: torch.Generator, batch: int, alpha: float = 1.0) -> torch.Tensor:
    """(batch,) float32 on the generator's device: lam ~ Beta(alpha, alpha)
    for each even row, 1 - lam for its odd partner."""
    conc = torch.full((batch // 2, 2), float(alpha), dtype=torch.float32, device=rng.device)
    lam = torch._sample_dirichlet(conc, generator=rng)[:, 0]  # Beta(a, a) = Dirichlet(a, a)'s first part
    return torch.stack([lam, 1.0 - lam], dim=1).reshape(-1)
