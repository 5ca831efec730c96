"""Model registry: a name maps to the bundle of the port's functions for that
model, under the JAX package's names (``mellow_tpu/models/registry.py``).

``count_params`` counts the elements of a tree of tensors."""

from __future__ import annotations

from types import SimpleNamespace


def get_audio_encoder(name: str = "HTSAT") -> SimpleNamespace:
    """The audio encoder's functions (reference: mellow/model/audio.py:3-7)."""
    if name != "HTSAT":
        raise ValueError(f"The audio encoder {name} is incorrect or not supported")
    from mellow_tpu_torch.models import htsat as h

    return SimpleNamespace(
        encode_audio=h.encode_audio,
        htsat_embedding=h.htsat_embedding,
        htsat_embedding_long=h.htsat_embedding_long,
        htsat_embedding_infer_mode=h.htsat_embedding_infer_mode,
        projection=h.projection,
        downsample_tokens=h.downsample_tokens,
    )


def get_model(model_type: str = "Mellow") -> SimpleNamespace:
    if model_type.lower() != "mellow":
        raise ValueError(f"The model {model_type} is not supported. Supported: ['Mellow']")
    from mellow_tpu_torch.models import mellow as m
    from mellow_tpu_torch.models.params import count_params

    return SimpleNamespace(
        init_params=m.init_params,
        generate_tokens=m.generate_tokens,
        encode_and_prefix=m.encode_and_prefix,
        build_prefix=m.build_prefix,
        forward_train=m.forward_train,
        count_params=count_params,
    )
