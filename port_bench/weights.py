"""Seeded random weights for a configuration, made on the device.

The tree is the one the program takes. Its leaves, [(path, shape,
kind)], come from the configuration's plain reference (``leaves`` of its
module under ``reference/``), which reads the same tree, so a new
architecture brings its own list with its reference.

A leaf's kind sets how it is drawn: "normal" N(0, 0.02) (matmul kernels
(in, out), tables, biases, bn0's mean); "scale" 1 + N(0, 0.1) (norm
scales); "var" 1 + |N(0, 0.1)| (bn0's variance). Each kind of leaf is
drawn in one call from one ``torch.Generator`` on the device, in float32,
and cast once to the served dtype; every leaf is a view into one of those
buffers, at an offset aligned to 128 elements.
"""

from __future__ import annotations

import torch

ALIGN = 128
STD = 0.02
SCALE_STD = 0.1


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _insert(tree, path, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        default = [] if isinstance(nxt, int) else {}
        if isinstance(key, int):
            while len(node) <= key:
                node.append(default.copy())
            node = node[key]
        else:
            node = node.setdefault(key, default)
    if isinstance(path[-1], int):
        node.append(value)
    else:
        node[path[-1]] = value


def make(specs: list, seed: int, device, dtype: torch.dtype) -> dict:
    """The weight tree of the leaves ``specs`` [(path, shape, kind)] from
    ``seed``, on ``device`` in ``dtype``."""
    offsets, sizes = {}, {}
    for path, shape, kind in specs:
        n = sizes.get(kind, 0)
        offsets[path] = n
        sizes[kind] = n + -(-_numel(shape) // ALIGN) * ALIGN
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    buffers = {}
    for kind in ("normal", "scale", "var"):  # a fixed order of draws
        if kind not in sizes:
            continue
        z = torch.randn(sizes[kind], generator=gen, device=device, dtype=torch.float32)
        if kind == "normal":
            z.mul_(STD)
        elif kind == "scale":
            z.mul_(SCALE_STD).add_(1.0)
        else:
            z.mul_(SCALE_STD).abs_().add_(1.0)
        buffers[kind] = z.to(dtype)
        del z
    tree = {}
    for path, shape, kind in specs:
        o = offsets[path]
        _insert(tree, path, buffers[kind][o: o + _numel(shape)].view(shape))
    return tree
