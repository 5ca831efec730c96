"""ReasonAQA evaluation: manifest loader, text metrics, and a batched
runner over ``MellowWrapper``. The port's copy of ``mellow_tpu/eval.py``;
``run_eval`` drives any wrapper with its ``generate`` signature, the
port's included.

The reference repo documents the evaluation workflow but ships no code
for it — README.md:81-114 describes the ReasonAQA JSON format (a list of
dicts with taskname / filepath1 / filepath2 / input / answer / subtype)
and tells the user to download the data and score the outputs
themselves. This module is that missing piece: it reads the exact
documented format and scores model outputs with the metrics the tasks
call for:

  * ``exact_match`` — normalized string equality, for the closed-form
    tasks (binary AQA yes/no, MCQ options, entailment labels).
  * ``token_f1`` — bag-of-tokens F1 (the SQuAD convention), for short
    free-form answers.
  * ``corpus_bleu`` — BLEU-1..4 with brevity penalty (Papineni et al.),
    for captioning / audio-difference outputs.
  * ``cider_d`` — CIDEr-D (Vedantam et al.), the standard audio/image
    captioning consensus metric: tf-idf-weighted n-gram cosine with
    length penalty. Pure numpy.
METEOR and SPICE are intentionally absent: both need external resources
(WordNet / a dependency parser) that are out of scope offline; BLEU +
CIDEr-D are the decisive pair in the Mellow paper family of benchmarks.

All metrics are pure Python/numpy (no device work); only ``run_eval``
touches the model. Tokenization is the standard PTB-ish lowercase +
punctuation strip both metric families use.
"""

from __future__ import annotations

import collections
import math
import string
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

_ARTICLES = {"a", "an", "the"}
_PUNCT = set(string.punctuation)


def normalize_text(s: str) -> str:
    """Lowercase, strip punctuation/articles, collapse whitespace (the
    SQuAD normalization — the convention for exact-match / token F1)."""
    s = s.lower()
    s = "".join(" " if c in _PUNCT else c for c in s)
    toks = [t for t in s.split() if t not in _ARTICLES]
    return " ".join(toks)


def tokenize(s: str) -> List[str]:
    return normalize_text(s).split()


def exact_match(pred: str, answer: str) -> float:
    return float(normalize_text(pred) == normalize_text(answer))


def token_f1(pred: str, answer: str) -> float:
    """Bag-of-tokens F1 (SQuAD convention: multiset overlap)."""
    p, a = tokenize(pred), tokenize(answer)
    if not p or not a:
        return float(p == a)
    common = collections.Counter(p) & collections.Counter(a)
    n_common = sum(common.values())
    if n_common == 0:
        return 0.0
    precision = n_common / len(p)
    recall = n_common / len(a)
    return 2 * precision * recall / (precision + recall)


def _ngrams(tokens: Sequence[str], n: int) -> collections.Counter:
    return collections.Counter(
        tuple(tokens[i: i + n]) for i in range(len(tokens) - n + 1)
    )


def corpus_bleu(
    preds: Sequence[str], refs: Sequence[Sequence[str]], max_n: int = 4
) -> Dict[str, float]:
    """Corpus-level BLEU-1..max_n with brevity penalty (Papineni et al.
    2002): clipped n-gram precision aggregated over the corpus,
    geometric mean across orders. ``refs[i]`` is the list of reference
    strings for ``preds[i]`` (>= 1 each)."""
    assert len(preds) == len(refs) and preds, "empty eval corpus"
    match = [0] * max_n
    total = [0] * max_n
    pred_len = 0
    ref_len = 0
    for pred, rlist in zip(preds, refs):
        p = tokenize(pred)
        rtoks = [tokenize(r) for r in rlist]
        pred_len += len(p)
        # closest reference length (standard multi-ref convention)
        ref_len += min(
            (abs(len(r) - len(p)), len(r)) for r in rtoks
        )[1]
        for n in range(1, max_n + 1):
            pn = _ngrams(p, n)
            if not pn:
                continue
            rmax = collections.Counter()
            for r in rtoks:
                rn = _ngrams(r, n)
                for g, c in rn.items():
                    rmax[g] = max(rmax[g], c)
            match[n - 1] += sum(min(c, rmax[g]) for g, c in pn.items())
            total[n - 1] += sum(pn.values())
    bp = (
        1.0
        if pred_len > ref_len
        else math.exp(1 - ref_len / max(pred_len, 1))
    )
    out = {}
    log_sum, valid = 0.0, True
    for n in range(1, max_n + 1):
        pn = match[n - 1] / total[n - 1] if total[n - 1] else 0.0
        # BLEU-n = geometric mean of orders 1..n times the brevity penalty.
        if pn > 0 and valid:
            log_sum += math.log(pn)
            out[f"bleu{n}"] = bp * math.exp(log_sum / n)
        else:
            valid = False
            out[f"bleu{n}"] = 0.0
    return out


def cider_d(
    preds: Sequence[str],
    refs: Sequence[Sequence[str]],
    max_n: int = 4,
    sigma: float = 6.0,
) -> float:
    """CIDEr-D (Vedantam et al. 2015): mean over n of tf-idf-weighted
    n-gram cosine similarity between candidate and references, with a
    Gaussian length penalty; scaled by 10 as in the official release.
    Document frequencies are computed over THIS corpus's reference sets
    (the official convention when no external corpus is supplied)."""
    import numpy as np

    assert len(preds) == len(refs) and preds
    n_docs = len(refs)
    doc_freq = [collections.Counter() for _ in range(max_n)]
    ref_ngrams: List[List[List[collections.Counter]]] = []
    for rlist in refs:
        per_ref = []
        seen = [set() for _ in range(max_n)]
        for r in rlist:
            toks = tokenize(r)
            counts = [_ngrams(toks, n + 1) for n in range(max_n)]
            per_ref.append(counts)
            for n in range(max_n):
                seen[n].update(counts[n].keys())
        for n in range(max_n):
            for g in seen[n]:
                doc_freq[n][g] += 1
        ref_ngrams.append(per_ref)

    # Official convention: tf-idf weight = RAW n-gram count x
    # (log N_docs - log df); length effects enter via the vector norms
    # and the Gaussian penalty. With a single document the idf term is 0
    # and so is the score (matches the official scorer's behavior).
    log_n = math.log(float(n_docs)) if n_docs > 1 else 0.0

    def tfidf(counts: collections.Counter, n: int):
        vec = {}
        norm = 0.0
        for g, c in counts.items():
            df = math.log(max(float(doc_freq[n][g]), 1.0))
            w = float(c) * max(log_n - df, 0.0)
            vec[g] = w
            norm += w * w
        return vec, math.sqrt(norm)

    scores = []
    for pred, rlist, per_ref in zip(preds, refs, ref_ngrams):
        p = tokenize(pred)
        p_counts = [_ngrams(p, n + 1) for n in range(max_n)]
        per_n = [0.0] * max_n
        for ref_counts, r in zip(per_ref, rlist):
            rtoks = tokenize(r)
            delta = len(p) - len(rtoks)
            len_pen = math.exp(-(delta ** 2) / (2 * sigma ** 2))
            for n in range(max_n):
                pv, pn = tfidf(p_counts[n], n)
                rv, rn = tfidf(ref_counts[n], n)
                if pn == 0 or rn == 0:
                    continue
                # CIDEr-D clips the candidate's weights to the
                # reference's (penalizes n-gram stuffing).
                dot = sum(min(w, rv[g]) * rv[g] for g, w in pv.items() if g in rv)
                per_n[n] += len_pen * dot / (pn * rn)
        scores.append(10.0 * sum(per_n) / (max_n * max(len(rlist), 1)))
    return float(np.mean(scores))


# ---------------------------------------------------------------------------
# Manifest + runner
# ---------------------------------------------------------------------------

# subtypes whose answers are closed-form (scored by exact match + F1);
# everything else is free-form text (BLEU + CIDEr-D + F1). Matching is by
# substring so "ClothoAQA-binary.json" and friends route sensibly.
_CLOSED_HINTS = ("binary", "mcq", "entail", "yes_no", "aqa")


@dataclass
class EvalExample:
    audio1: str
    audio2: str  # == audio1 when the task has a single clip
    prompt: str
    answer: str
    subtype: str
    taskname: str = ""


@dataclass
class SubtypeReport:
    n: int
    metrics: Dict[str, float] = field(default_factory=dict)


def load_manifest(path: str, audio_root: Optional[str] = None) -> List[EvalExample]:
    """Read the documented ReasonAQA JSON (reference README.md:89-114) via
    the training pipeline's loader (train/data.py — single source of truth
    for the schema). ``filepath2`` is empty for single-audio tasks — the
    reference's own examples pass the same clip twice in that case."""
    from mellow_tpu_torch.train.data import load_json

    rows = load_json(path, audio_root or "")
    return [
        EvalExample(
            audio1=r.filepath1,
            audio2=r.filepath2 or r.filepath1,
            prompt=r.input,
            answer=r.answer,
            subtype=r.subtype or "default",
            taskname=getattr(r, "taskname", ""),
        )
        for r in rows
    ]


def is_closed_form(subtype: str) -> bool:
    s = subtype.lower()
    return any(h in s for h in _CLOSED_HINTS)


def score_group(
    preds: Sequence[str], answers: Sequence[str], subtype: str
) -> Dict[str, float]:
    refs = [[a] for a in answers]
    out = {
        "exact_match": sum(exact_match(p, a) for p, a in zip(preds, answers))
        / len(preds),
        "token_f1": sum(token_f1(p, a) for p, a in zip(preds, answers))
        / len(preds),
    }
    if not is_closed_form(subtype):
        out.update(corpus_bleu(preds, refs))
        out["cider_d"] = cider_d(preds, refs)
    return out


def run_eval(
    wrapper,
    examples: List[EvalExample],
    *,
    batch_size: int = 32,
    max_len: int = 300,
    stop_token: str = "<|endoftext|>",
) -> Tuple[Dict[str, SubtypeReport], List[str]]:
    """Drive ``MellowWrapper.generate`` over the manifest in batches and
    score per subtype. Returns ({subtype: SubtypeReport}, predictions in
    manifest order). Uses the wrapper's reference-parity generate
    signature (mellow/wrapper.py:258)."""
    preds: List[str] = []
    for i in range(0, len(examples), batch_size):
        chunk = examples[i: i + batch_size]
        batch = [[e.audio1, e.audio2, e.prompt] for e in chunk]
        preds.extend(
            wrapper.generate(
                examples=batch, max_len=max_len, stop_token=stop_token
            )
        )
    groups: Dict[str, List[int]] = collections.defaultdict(list)
    for idx, e in enumerate(examples):
        groups[e.subtype].append(idx)
    reports = {}
    for subtype, idxs in sorted(groups.items()):
        reports[subtype] = SubtypeReport(
            n=len(idxs),
            metrics=score_group(
                [preds[i] for i in idxs],
                [examples[i].answer for i in idxs],
                subtype,
            ),
        )
    # Size-weighted overall row for the metrics every subtype shares.
    n_all = len(examples)
    reports["OVERALL"] = SubtypeReport(
        n=n_all,
        metrics={
            m: sum(r.metrics[m] * r.n for r in reports.values()) / n_all
            for m in ("exact_match", "token_f1")
        },
    )
    return reports, preds


def format_report(reports: Dict[str, SubtypeReport]) -> str:
    lines = []
    for subtype, rep in reports.items():
        ms = "  ".join(f"{k}={v:.4f}" for k, v in sorted(rep.metrics.items()))
        lines.append(f"{subtype:<24} n={rep.n:<6} {ms}")
    return "\n".join(lines)
