"""The correctness check of a served cell, run after the window has closed.

A sample of requests, drawn from the seed before the window (with a row of
a call of the longest ``max_len`` in it), is read where the window serves
it: on the window's first pass over the input pool the harness keeps, for
the sampled rows, what the program made on the way to the tokens
(``harness.Tap``): its prefix, the logits it chose each token from, and
the keys and values its decode steps left in the cache. After the window,
the plain float32 reference works the sampled requests out again, from
their clips and prompts with the served tokens fed back, and the check
reads:

  max_logit_gap    the widest gap by which a served token's reference logit
                   lies below the reference's best at its position;
  logits_rel_err   the program's logits against the reference's at every
                   served position: the root-mean-square of their
                   difference over that of the reference's (each
                   position's logits taken about their mean);
  prefix_rel_err   the program's prefix against the reference's over the
                   audio rows (all but the prompt's): the encoder, the
                   projection and the prefix's assembly;
  decoder_rel_err  the program's logits against the reference decoder's
                   run on the program's own prefix, as logits_rel_err,
                   the worst served position: the decoder alone (the
                   prefill, the token choices and the decode steps);
  cache_rel_err    the keys and values the decode steps left in the cache,
                   every layer, against the reference decoder's (run on
                   the program's prefix) at the same positions;
  first_layer_kv_rel_err
                   the first layer's keys and values at every position
                   the call wrote (the prefill's and the decode steps'),
                   against the same: one layer's arithmetic from inputs
                   that both sides share, where a lower precision shows
                   before the layers after it add their rounding.

The last three follow the program from its own prefix, which prefix_rel_err
checks by itself; the first two follow the whole chain from the inputs.
The numbers a cell compares are those its limits file names. Beside them,
the answers that never came whole (a row missing from the call's tokens,
an id outside the vocabulary, or a call that stopped before ``max_len``
with the row's stop token not served) are counted, with the limit 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BLOCK = 16  # requests a reference block


class Served(NamedTuple):
    pool_index: int  # the input batch of the pool the call used
    tokens: np.ndarray  # (B, max_len) int
    steps: int
    max_len: int


def sample(pool: list, mix: dict, seed: int) -> dict:
    """{pool index: sorted rows}: ``check_requests`` distinct requests of
    the pool, drawn from ``seed``, at least one of them in a batch of the
    longest ``max_len``."""
    rng = np.random.default_rng(seed)
    sizes = [len(b.text_ids) for b in pool]
    starts = np.cumsum([0] + sizes)
    picked = [int(x) for x in rng.choice(starts[-1], size=min(mix["check_requests"], starts[-1]), replace=False)]
    longest = max(b.max_len for b in pool)
    batches = [int(np.searchsorted(starts, i, side="right")) - 1 for i in picked]
    if all(pool[p].max_len < longest for p in batches):
        p = next(j for j, b in enumerate(pool) if b.max_len == longest)
        picked[-1] = int(starts[p] + rng.integers(sizes[p]))
    out = {}
    for i in sorted(set(picked)):
        p = int(np.searchsorted(starts, i, side="right")) - 1
        out.setdefault(p, []).append(i - int(starts[p]))
    return out


def missing(served: list, pool: list, cfg: dict) -> int:
    """Answers that did not come whole, counted per request."""
    V, stop = cfg["decoder"]["vocab_size"], cfg["stop_token_id"]
    n = 0
    for s in served:
        B = len(pool[s.pool_index].text_ids)
        tok = s.tokens[:, :s.steps]
        bad = ((tok < 0) | (tok >= V)).any(-1)
        if s.steps < s.max_len:
            bad |= ~(tok == stop).any(-1)
        n += B - tok.shape[0] + int(bad.sum())
    return n


class _Sums:
    """Running sums of squares of a difference and of its reference."""

    def __init__(self):
        self.d = self.r = 0.0

    def add(self, diff: torch.Tensor, ref: torch.Tensor) -> None:
        self.d += float(diff.double().square().sum())
        self.r += float(ref.double().square().sum())

    def value(self) -> float:
        return float(np.sqrt(self.d / self.r)) if self.r > 0 else float("inf")


def _centred(x: torch.Tensor) -> torch.Tensor:
    return x - x.mean(-1, keepdim=True)


def readings(ref, params: dict, cfg: dict, pool: list, requests: dict, device, control=None) -> dict:
    """Every reading over the sampled requests: ``requests`` {pool index:
    (rows, served tokens (r, n), the program's prefix (r, P, D), logits (r,
    n, V), kv_decode, kv_first (``harness.Tap``'s, or None))}, the
    program's outputs on the device. ``control``: a lower-precision product for
    every matrix product of the reference, which then stands in the
    program's place, at the same prompts and served tokens; its gap is that
    of the token it puts first."""
    inf = float("inf")
    if not requests:
        return {"max_logit_gap": inf, "logits_rel_err": inf, "prefix_rel_err": inf, "decoder_rel_err": inf,
                "decoder_rel_err_by_position": [], "cache_rel_err": None, "first_layer_kv_rel_err": None,
                "flip_share": 1.0}
    p32 = ref.to_f32(params)
    T = cfg["text_tokenization_len"]
    gap, flips, chosen_n = 0.0, 0, 0
    full, prefix = _Sums(), _Sums()
    kv = {"cache_rel_err": _Sums(), "first_layer_kv_rel_err": _Sums()}
    per_pos = {}
    finite = True
    for p in sorted(requests):
        rows, tokens, prog_prefix, prog_logits, prog_decode, prog_first = requests[p]
        for s in range(0, len(rows), BLOCK):
            sl = slice(s, s + BLOCK)
            r = rows[sl]
            w1 = torch.from_numpy(pool[p].wave1[r]).to(device)
            w2 = torch.from_numpy(pool[p].wave2[r]).to(device)
            ids = torch.from_numpy(pool[p].text_ids[r]).to(device)
            tok = torch.as_tensor(tokens[sl], device=device).long()
            ref_prefix = ref.prefix(p32, cfg, w1, w2, ids)
            ref_logits = ref.decode(p32, cfg, ref_prefix, tok)[0]
            if control is None:
                got_prefix = prog_prefix[sl].float()
                got_logits = prog_logits[sl].float()
                got = {"cache_rel_err": prog_decode, "first_layer_kv_rel_err": prog_first}
                got = {k: None if x is None else tuple(t[:, sl] for t in x) for k, x in got.items()}
                chosen = tok
            else:
                got_prefix = ref.prefix(p32, cfg, w1, w2, ids, mm=control)
                got_logits, ck, cv = ref.decode(p32, cfg, got_prefix, tok, mm=control)
                P = got_prefix.shape[1]
                got = {"cache_rel_err": (ck[:, :, P:], cv[:, :, P:]), "first_layer_kv_rel_err": (ck[:1], cv[:1])}
                chosen = got_logits.argmax(-1)
            if got_logits.shape[1] != tok.shape[1]:  # fewer logits than served tokens
                finite = False
                continue
            dec_logits, dk, dv = ref.decode(p32, cfg, got_prefix, tok)
            P = got_prefix.shape[1]
            want = {"cache_rel_err": (dk[:, :, P:], dv[:, :, P:]), "first_layer_kv_rel_err": (dk[:1], dv[:1])}
            finite &= bool(torch.isfinite(got_prefix).all() and torch.isfinite(got_logits).all())
            g = ref_logits.max(-1).values - ref_logits.gather(-1, chosen[..., None])[..., 0]
            gap = max(gap, float(g.max()))
            flips += int((g > 0).sum())
            chosen_n += g.numel()
            full.add(_centred(got_logits - ref_logits), _centred(ref_logits))
            audio = slice(0, ref_prefix.shape[1] - T)
            prefix.add(got_prefix[:, audio] - ref_prefix[:, audio], ref_prefix[:, audio])
            for t in range(tok.shape[1]):
                per_pos.setdefault(t, _Sums()).add(_centred(got_logits[:, t] - dec_logits[:, t]),
                                                   _centred(dec_logits[:, t]))
            for name, sums in kv.items():
                g, w = got[name], want[name]
                if g is None or g[0].shape != w[0].shape or sums is None:
                    kv[name] = None
                else:
                    sums.add(torch.cat([(g[0] - w[0]).flatten(), (g[1] - w[1]).flatten()]),
                             torch.cat([w[0].flatten(), w[1].flatten()]))
    return {"max_logit_gap": gap if finite else inf,
            "logits_rel_err": full.value() if finite else inf,
            "prefix_rel_err": prefix.value() if finite else inf,
            "decoder_rel_err": max(v.value() for v in per_pos.values()) if finite and per_pos else inf,
            "decoder_rel_err_by_position": [per_pos[t].value() for t in sorted(per_pos)],
            **{name: (sums.value() if finite else inf) if sums is not None else None for name, sums in kv.items()},
            "flip_share": flips / max(chosen_n, 1)}


def tapped(served: list, taps: dict) -> dict:
    """The ``readings`` input of the window's tapped calls: {pool index:
    (rows, tokens, prefix, logits, kv_decode, kv_first)} of the first call
    on each tapped input, its rows that the call served."""
    out = {}
    for p in sorted(taps):
        tap, s = taps[p], served[p]
        keep = [i for i, r in enumerate(tap.rows.tolist()) if r < s.tokens.shape[0]]
        if not keep or tap.prefix_rows is None or not tap.kept:
            continue
        idx = torch.tensor(keep, device=tap.rows.device)
        rows = [tap.rows.tolist()[i] for i in keep]
        kv = [None if x is None else tuple(t.index_select(1, idx) for t in x) for x in (tap.kv_decode, tap.kv_first)]
        out[p] = (rows, s.tokens[rows, :s.steps], tap.prefix_rows.index_select(0, idx),
                  torch.stack(tap.kept, 1)[:, :s.steps].index_select(0, idx), *kv)
    return out


def run(ref, params, cfg, mix, limits, pool, served, taps, device):
    """(correct, {name: {"value", "limit"}}) of the window's answers: each
    number that ``limits`` names, and the answers missing."""
    got = readings(ref, params, cfg, pool, tapped(served, taps), device)
    checks = {name: {"value": got.get(name), "limit": float(limit)} for name, limit in limits.items()}
    checks["answers_missing"] = {"value": missing(served, pool, cfg), "limit": 0}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
