"""The full v0 model's teacher-forced forward step as one function with
example arguments, and the multi-device dry run.

``entry()`` returns ``(fn, example_args)``: ``fn(*example_args)`` encodes two
10 s clips with HTSAT, assembles the 389-token prefix, appends 16 answer
tokens' embeddings and returns SmolLM2-shape teacher-forced logits
(1, 405, 49152), the JAX package's ``__graft_entry__.entry`` on the port.
``dryrun_multichip`` is ``parallel.dryrun.dryrun_multichip``.
"""

from __future__ import annotations

import numpy as np
import torch

from mellow_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: F401

ANSWER_LEN = 16


def entry(device="cuda"):
    """``(fn, example_args)`` for v0 in bf16 on ``device``, with the port's
    seed-0 random weights (``models.mellow.init_params``).

    ``fn(params, audio1, audio2, text_ids, answer_ids)`` runs
    ``encode_and_prefix`` (on a card: the log-mel kernel once a clip and
    the Swin block kernel in each block of stages 1-3), concatenates the
    answer tokens' embeddings after the prefix and returns
    ``llama.forward``'s logits (B, 389 + 16, V) in the plain formulation.

    The example arguments are the JAX entry's, bit for bit: from
    ``np.random.RandomState(0)``, two (1, 320000) clips of ``randn`` cast
    to bf16 and times 0.1 rounded to bf16 (what JAX's weakly typed scalar
    multiplies by), then 129 text ids and 16 answer ids from
    ``randint(2, 49000)``, as int64."""
    from mellow_tpu_torch.config import get_config
    from mellow_tpu_torch.models import llama
    from mellow_tpu_torch.models.mellow import encode_and_prefix, init_params
    from mellow_tpu_torch.models.params import params_from_jax

    cfg = get_config("v0")
    device = torch.device(device)
    params = params_from_jax(init_params(cfg, 0), device, torch.bfloat16)

    def fn(params, audio1, audio2, text_ids, answer_ids):
        prefix = encode_and_prefix(params, cfg, audio1, audio2, text_ids)
        with torch.no_grad():
            answers = params["decoder"]["embed"][answer_ids].to(prefix.dtype)
            seq = torch.cat([prefix, answers], dim=1)
            return llama.forward(params["decoder"], cfg.decoder, seq)

    B = 1
    rng = np.random.RandomState(0)
    tenth = torch.tensor(0.1, dtype=torch.bfloat16)

    def clip():
        wave = torch.from_numpy(rng.randn(B, 320000).astype(np.float32)).to(torch.bfloat16)
        return (wave * tenth).to(device)

    def ids(n):
        return torch.from_numpy(rng.randint(2, 49000, (B, n)).astype(np.int64)).to(device)

    example_args = (params, clip(), clip(), ids(cfg.text_tokenization_len), ids(ANSWER_LEN))
    return fn, example_args
