"""YAML config compatibility.

The reference selects configs by YAML file (mellow/config/v0.yaml loaded at
wrapper.py:51-57 into an argparse.Namespace). The port's copy of
``mellow_tpu/config_yaml.py``: its source of truth is the frozen dataclass
tree in mellow_tpu_torch/config.py, but users migrating custom YAMLs can
load them directly: this module maps the reference schema
(data/model/encoder/decoder keys, see v0.yaml) onto MellowConfig, with
optional extended keys (encoder_arch, decoder_arch). PyYAML is imported
only when a file is loaded.

    from mellow_tpu_torch.config_yaml import load_yaml_config, register_yaml_config
    cfg = load_yaml_config("my_config.yaml")
    register_yaml_config("mine", "my_config.yaml")   # get_config("mine")
"""

from __future__ import annotations

from mellow_tpu_torch.config import (
    FrontendConfig,
    HTSATConfig,
    LlamaConfig,
    MellowConfig,
    register_config,
)


def load_yaml_config(path: str, name: str = "custom") -> MellowConfig:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)

    data = raw.get("data", {})
    model = raw.get("model", {})
    enc = model.get("encoder", {})
    dec = model.get("decoder", {})

    if enc.get("audioenc_name", "HTSAT") != "HTSAT":
        raise ValueError(
            f"unsupported audio encoder '{enc.get('audioenc_name')}' "
            "(reference supports only HTSAT, mellow/model/audio.py:3-7)"
        )
    if model.get("model_type", "Mellow") != "Mellow":
        raise ValueError(
            f"unsupported model_type '{model.get('model_type')}' "
            "(reference: mellow/model/model.py:3-7)"
        )

    text_decoder = dec.get("text_decoder", "HuggingFaceTB/SmolLM2-135M")
    family = "gpt2" if "gpt" in text_decoder.lower() else "llama"

    frontend = FrontendConfig(
        sample_rate=int(data.get("sampling_rate", 32000)),
        segment_seconds=int(data.get("segment_seconds", 10)),
    )
    # Extended sections are optional.
    enc_extra = raw.get("encoder_arch", {})
    encoder = HTSATConfig(
        out_emb=int(enc.get("out_emb", 768)),
        **{k: v for k, v in enc_extra.items() if k in HTSATConfig.__dataclass_fields__},
    )
    dec_extra = raw.get("decoder_arch", {})
    if family == "llama":
        decoder = LlamaConfig(
            **{k: v for k, v in dec_extra.items() if k in LlamaConfig.__dataclass_fields__}
        )
        sep = stop = 0  # smollm2 (decoder.py:49, wrapper.py:208)
    else:
        from mellow_tpu_torch.models.gpt2 import GPT2Config

        decoder = GPT2Config(
            **{k: v for k, v in dec_extra.items()
               if k in GPT2Config.__dataclass_fields__}
        )
        sep = stop = 50256  # gpt2 '<|endoftext|>' (decoder.py:44)

    cfg = MellowConfig(
        name=name,
        frontend=frontend,
        encoder=encoder,
        decoder=decoder,
        d_proj=int(enc.get("d_proj", 576)),
        text_tokenization_len=int(data.get("text_tokenization_len", 129)),
        prefix_length=int(dec.get("prefix_length", 389)),
        decoder_family=family,
        text_decoder=text_decoder,
        sep_token_id=sep,
        stop_token_id=stop,
    )
    return cfg.validate()


def register_yaml_config(name: str, path: str) -> MellowConfig:
    cfg = load_yaml_config(path, name)
    register_config(name, cfg)
    return cfg
