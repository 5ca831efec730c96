"""Shared scaffolding of the port's entry points (server, eval runner,
examples): a wrapper builder with the standard weight resolution.

Weights resolve as ``MellowWrapper`` resolves them (``params_path``, then
``MELLOW_TPU_PARAMS``, then ``MELLOW_TPU_CKPT``). With none reachable, the
builder falls back to random weights from seed 0 and the byte tokenizer, so
the pipelines run end to end offline (the outputs are gibberish; the
timings are real), as ``mellow_tpu/cli.py`` does.
"""

from __future__ import annotations

import sys


def build_wrapper(config: str = "v0", model: str = "v0", device="cuda", **kw):
    """``MellowWrapper(config, model, device, **kw)``, or, when no weights
    are reachable, the same with random weights (``models.mellow.
    init_params(cfg, 0)``) and ``ByteTokenizer``."""
    from mellow_tpu_torch.wrapper import MellowWrapper

    try:
        return MellowWrapper(config, model, device, **kw)
    except RuntimeError as e:
        if "No weights available" not in str(e):
            raise
    print(
        "[mellow_tpu_torch] no checkpoint reachable: using RANDOM weights and the byte tokenizer "
        "(pipeline demo only; set MELLOW_TPU_PARAMS or MELLOW_TPU_CKPT for real outputs)",
        file=sys.stderr,
    )
    from mellow_tpu_torch.config import get_config
    from mellow_tpu_torch.io.tokenizer import ByteTokenizer
    from mellow_tpu_torch.models.mellow import init_params

    kw.setdefault("tokenizer", ByteTokenizer())
    return MellowWrapper(config, model, device, params=init_params(get_config(config), 0), **kw)
