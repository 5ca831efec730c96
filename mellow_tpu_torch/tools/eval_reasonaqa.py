"""Evaluate a Mellow checkpoint on a ReasonAQA-format manifest, with the
PyTorch port (the port's copy of ``mellow_tpu/tools/eval_reasonaqa.py``;
``--device`` and ``--compute-dtype`` are the port's).

The reference documents the ReasonAQA evaluation data + format
(README.md:81-114: download test.json from Zenodo, audio from
Clotho/AudioCaps) but ships no evaluation code; this is the runner. It
reads the exact documented JSON, drives ``MellowWrapper.generate`` in
batches, and reports per-subtype metrics (exact match + token F1 for the
closed-form tasks; BLEU-1..4 + CIDEr-D added for free-form captioning /
difference tasks) — see mellow_tpu/eval.py.

Usage:
    mellow-tpu-torch-eval test.json --audio-root /data/audio \
        [--config v0] [--model v0] [--device cuda] [--compute-dtype bfloat16] \
        [--batch-size 32] [--max-len 300] [--limit N] [--out preds.json]

Weights resolve exactly like the examples: MELLOW_TPU_PARAMS /
MELLOW_TPU_CKPT env vars; without either this falls back to random
weights (pipeline smoke only — scores are meaningless).
"""

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("manifest", help="ReasonAQA-format JSON file")
    ap.add_argument("--audio-root", default=None,
                    help="prefix joined onto the manifest's filepaths")
    ap.add_argument("--config", default="v0")
    ap.add_argument("--model", default="v0")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compute-dtype", default=None, choices=[None, "float32", "bfloat16"])
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=300)
    ap.add_argument("--limit", type=int, default=0,
                    help="evaluate only the first N examples")
    ap.add_argument("--out", default=None,
                    help="write predictions + per-subtype metrics as JSON")
    args = ap.parse_args(argv)

    from mellow_tpu_torch import eval as ev
    from mellow_tpu_torch.cli import build_wrapper

    examples = ev.load_manifest(args.manifest, args.audio_root)
    if args.limit:
        examples = examples[: args.limit]
    print(f"{len(examples)} examples, "
          f"{len({e.subtype for e in examples})} subtypes", file=sys.stderr)

    wrapper = build_wrapper(args.config, args.model, args.device, compute_dtype=args.compute_dtype)
    reports, preds = ev.run_eval(
        wrapper, examples, batch_size=args.batch_size, max_len=args.max_len
    )
    print(ev.format_report(reports))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(
                {
                    "metrics": {
                        k: {"n": r.n, **r.metrics} for k, r in reports.items()
                    },
                    "predictions": preds,
                },
                f,
                indent=1,
            )
        print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
