"""Readings that set a cell's correctness limits: the program's numbers over
many seeds, its control's, and the faults'.

The control is the program with its int8 path switched on (the nearest
precision below the configuration's bfloat16): W8A8 decoder weights and an
int8 KV cache (the "serve" options ``INT8``), through the same entry, on
the same inputs. Beside it, the plain reference itself with every matrix
product's inputs rounded to fp8 (e4m3, scaled by each row's and each
column's largest magnitude) standing in the program's place at the
program's prompts and served tokens. The faults, each planted in the
program under the same entry: a token altered where it is produced
(``AlteredToken``), a decode step that returns its cache unchanged
(``StaleCache``), and one Swin block of the encoder's third stage left
out (``SkippedBlock``).

For each seed the run makes the cell's weights and pool, warms up, serves
each batch of the pool once at the cell's own size, and reads every number
of ``check.readings`` over the same sample of requests a run draws. On the
control seeds it also reads the control, the fp8 reference and the
faults. The benchmark's own runs never run this.

    python3 port_bench/control.py --workload <name> --seeds 1,2,...
        --control-seeds 1,2,3 [--out FILE]
"""

import argparse
import functools
import inspect
import json
import os
import sys
import time
from contextlib import ExitStack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from port_bench import check, generator, harness, spec, weights  # noqa: E402

INT8 = {"weight_dtype": "int8-w8a8", "kv_cache_dtype": "int8"}


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with a's rows and b's columns rounded to float8 e4m3, each
    scaled by its largest magnitude, the product in float32."""
    def q(x, dim):
        s = x.abs().amax(dim, keepdim=True).clamp_min(1e-12) / 448.0
        return (x / s).to(torch.float8_e4m3fn).float() * s

    return q(a, -1) @ q(b, -2)


class Faulty(harness.Model):
    """The program with a fault planted under its entry while it runs:
    ``patches`` [(module, attribute, make)], each attribute replaced by
    ``make(original, model)``."""

    def patches(self) -> list:
        return []

    def generate(self, a1, a2, ids, max_len):
        with ExitStack() as stack:
            for module, attr, make in self.patches():
                orig = getattr(module, attr)
                setattr(module, attr, make(orig, self))
                stack.callback(setattr, module, attr, orig)
            return super().generate(a1, a2, ids, max_len)


class AlteredToken(Faulty):
    """Every token the next id after the program's choice."""

    def patches(self):
        from mellow_tpu_torch.models import generate as gen

        def make(orig, model):
            return lambda logits, **kw: (orig(logits, **kw) + 1) % logits.shape[-1]
        return [(gen, "_sample_token", make)]


class StaleCache(Faulty):
    """Each decode step returns the cache as it found it: what it wrote at
    its position is put back."""

    def patches(self):
        def make(orig, model):
            sig = inspect.signature(orig)

            @functools.wraps(orig)
            def step(*args, **kwargs):
                a = sig.bind(*args, **kwargs).arguments
                cache, pos = a["cache"], a["pos"]
                saved = [(t, t[:, :, pos].clone()) for t in cache if t is not None]
                out = orig(*args, **kwargs)
                for t, old in saved:
                    t[:, :, pos] = old
                return out
            return step
        return [(harness.family_module(self.cfg), "decode_step", make)]


class SkippedBlock(Faulty):
    """The last Swin block of the encoder's third stage returns its input."""

    def patches(self):
        from mellow_tpu_torch.models import htsat

        def make(orig, model):
            skipped = model.params["encoder"]["stages"][2]["blocks"][-1]

            @functools.wraps(orig)
            def block(x, p, *args, **kwargs):
                return x if p is skipped else orig(x, p, *args, **kwargs)
            return block
        return [(htsat, "swin_block", make)]


def serve(model, pool: list, sample: dict, device):
    """One pass over the pool at the cell's size, after a warm-up call, the
    rows of ``sample`` tapped -> (``check.readings``' requests, answers
    missing)."""
    model.call(pool[0])
    taps = {p: harness.Tap(rows, model.cfg, device) for p, rows in sample.items()}
    served = [check.Served(i, *model.call(b, tap=taps.get(i)), b.max_len) for i, b in enumerate(pool)]
    return check.tapped(served, taps), check.missing(served, pool, model.cfg)


def run(root: str, workload: str, seeds: list, control_seeds: list, device) -> dict:
    cell = spec.load(root, workload)
    ref = spec.reference(root, cell.cfg)
    dt = harness.DTYPES[cell.cfg["compute_dtype"]]
    sides = ("program", "control", "fp8_reference", "altered_token", "stale_cache", "skipped_block")
    out = {"workload": workload, **{side: {} for side in sides}}
    for seed in seeds:
        t = time.perf_counter()
        s = harness.seeds(seed)
        params = weights.make(ref.leaves(cell.cfg), s["weights"], device, dt)
        pool = generator.make_pool(cell.mix, cell.cfg, s["inputs"], device)
        models = {"program": harness.Model(cell.cfg, cell.mix, params, device)}
        if seed in control_seeds:
            models.update(control=harness.Model(dict(cell.cfg, serve=INT8), cell.mix, params, device),
                          altered_token=AlteredToken(cell.cfg, cell.mix, params, device),
                          stale_cache=StaleCache(cell.cfg, cell.mix, params, device),
                          skipped_block=SkippedBlock(cell.cfg, cell.mix, params, device))
        sample = check.sample(pool, cell.mix, s["check"])
        for side, model in models.items():
            requests, miss = serve(model, pool, sample, device)
            out[side][seed] = dict(check.readings(ref, params, cell.cfg, pool, requests, device),
                                   answers_missing=miss)
            if side == "program" and seed in control_seeds:
                out["fp8_reference"][seed] = check.readings(ref, params, cell.cfg, pool, requests, device,
                                                            control=fp8_matmul)
        del models
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t,
                          **{side: out[side].get(seed) for side in sides}}), flush=True)
        del params, pool
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    for side in sides:
        for name in ("max_logit_gap", "logits_rel_err", "prefix_rel_err", "decoder_rel_err", "cache_rel_err",
                     "first_layer_kv_rel_err"):
            vals = [r[name] for r in out[side].values() if r.get(name) is not None]
            if vals:
                out[f"{side}.{name}"] = {"max": max(vals), "min": min(vals)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(x) for x in args.seeds.split(",")]
    ctrl = [int(x) for x in args.control_seeds.split(",") if x]
    res = run(ROOT, args.workload, seeds, ctrl, torch.device("cuda:0"))
    res["card"] = harness.power_limit()
    text = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
