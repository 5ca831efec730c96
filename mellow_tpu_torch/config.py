"""Configuration tree for the Mellow port: the port's own copy of the
dataclasses and the registry of ``mellow_tpu/config.py`` (the port imports
nothing of the JAX package). Its registry is separate from that one.

One frozen dataclass tree replaces the reference's three uncoordinated config
mechanisms (YAML->Namespace at mellow/wrapper.py:51-57, module constants at
mellow/model/config.py:1-10, constructor kwargs at mellow/model/htsat.py:599-606).
All cross-file invariants the reference leaves implicit are asserted in
``MellowConfig.validate`` (see SURVEY.md section 5.6).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class FrontendConfig:
    """Log-mel front-end (reference: mellow/model/htsat.py:637-657 + config.py:4-9)."""

    sample_rate: int = 32000
    segment_seconds: int = 10
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 320
    n_mels: int = 64
    fmin: float = 50.0
    fmax: float = 14000.0
    ref: float = 1.0
    amin: float = 1e-10
    top_db: Optional[float] = None  # reference: None (htsat.py:644)

    @property
    def num_samples(self) -> int:
        return self.sample_rate * self.segment_seconds  # 320000

    @property
    def num_frames(self) -> int:
        # center=True STFT: 1 + num_samples // hop  (= 1001)
        return 1 + self.num_samples // self.hop_length

    @property
    def num_bins(self) -> int:
        return self.n_fft // 2 + 1  # 513


@dataclass(frozen=True)
class HTSATConfig:
    """HTSAT Swin encoder (reference: mellow/model/htsat.py:599-606)."""

    spec_size: int = 256
    patch_size: int = 4
    patch_stride: int = 4
    in_chans: int = 1
    num_classes: int = 527
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1  # training only (htsat.py:603)
    mel_bins: int = 64
    out_emb: int = 768  # = embed_dim * 2**(len(depths)-1)

    @property
    def freq_ratio(self) -> int:
        # reference: htsat.py:638 (spec_size // mel_bins = 4)
        return self.spec_size // self.mel_bins

    @property
    def grid_size(self) -> int:
        return self.spec_size // self.patch_stride  # 64

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))  # 768

    @property
    def target_frames(self) -> int:
        # time frames after bicubic resize (htsat.py:832-837): 4 * 256 = 1024
        return self.spec_size * self.freq_ratio


@dataclass(frozen=True)
class LlamaConfig:
    """SmolLM2-135M shape (reference loads it via HF AutoModelForCausalLM,
    mellow/model/decoder.py:25). Values mirror the published
    HuggingFaceTB/SmolLM2-135M config.json; the checkpoint converter
    (tools/convert_ckpt.py) re-verifies them against the downloaded config."""

    vocab_size: int = 49152
    hidden_size: int = 576
    intermediate_size: int = 1536
    num_layers: int = 30
    num_heads: int = 9
    num_kv_heads: int = 3
    head_dim: int = 64
    rope_theta: float = 100000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 8192

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


@dataclass(frozen=True)
class MellowConfig:
    """Full model config (reference: mellow/config/v0.yaml)."""

    name: str = "v0"
    frontend: FrontendConfig = FrontendConfig()
    encoder: HTSATConfig = HTSATConfig()
    decoder: LlamaConfig = LlamaConfig()
    d_proj: int = 576  # projection output dim (v0.yaml:12)
    text_tokenization_len: int = 129  # v0.yaml:5
    prefix_length: int = 389  # v0.yaml:15
    # Decoder family: "llama" (SmolLM2, the shipped checkpoints) or "gpt2"
    # (the reference's alternate branch, decoder.py:26-27,41-45).
    decoder_family: str = "llama"
    text_decoder: str = "HuggingFaceTB/SmolLM2-135M"  # v0.yaml:14
    sep_token_id: int = 0  # smollm2 separator (decoder.py:49); gpt2: 50256
    stop_token_id: int = 0  # '<|endoftext|>' for SmolLM2 (wrapper.py:208)
    pad_token_id: int = 1  # '!' — the reference remaps pad to '!' (wrapper.py:84)
    projection_dropout: float = 0.5  # train only (mellow.py:39)
    # TPU execution knobs (new; the reference has no equivalents)
    compute_dtype: str = "float32"  # "float32" (parity) | "bfloat16" (perf)

    @property
    def audio_prefix_len(self) -> int:
        # 1 clip token + 1024/8 pooled tokens (decoder.py:14-18)
        return 1 + (self.encoder.target_frames // 8)

    def validate(self) -> "MellowConfig":
        fe, enc, dec = self.frontend, self.encoder, self.decoder
        assert enc.mel_bins == fe.n_mels, "encoder mel_bins != frontend n_mels"
        assert enc.spec_size % enc.mel_bins == 0 and enc.freq_ratio == 4
        assert self.d_proj == dec.hidden_size, (
            "projection dim must equal LM hidden size (SURVEY.md 5.6)"
        )
        if self.decoder_family == "llama":
            assert dec.num_heads % dec.num_kv_heads == 0
            assert dec.head_dim * dec.num_heads == dec.hidden_size
        expected_prefix = 2 * self.audio_prefix_len + 2 + self.text_tokenization_len
        assert self.prefix_length == expected_prefix, (
            f"prefix_length {self.prefix_length} != derived {expected_prefix}"
        )
        assert fe.num_samples == 320000 and fe.num_frames == 1001
        return self

    def replace(self, **kw) -> "MellowConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY = {}


def register_config(name: str, cfg: MellowConfig) -> None:
    _REGISTRY[name] = cfg.validate()


def get_config(name: str) -> MellowConfig:
    if name not in _REGISTRY:
        raise ValueError(
            f"Unknown config '{name}'. Available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


# "v0" and "v0_s" share the architecture; they differ only in checkpoint
# (reference: wrapper.py:30-33, README.md:34).
register_config("v0", MellowConfig(name="v0"))
register_config("v0_s", MellowConfig(name="v0_s"))
