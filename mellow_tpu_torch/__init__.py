"""mellow_tpu_torch: the Mellow audio-language model in PyTorch and CUDA.

A port of the JAX package ``mellow_tpu`` (kept beside it as the reference)
to PyTorch on an NVIDIA GPU, with hand-written Hopper kernels in place of
the JAX package's Pallas kernels. It imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

from mellow_tpu_torch.config import MellowConfig, get_config  # noqa: F401


def __getattr__(name):
    # Lazy, so that importing the package does not pull in the model code.
    if name == "MellowWrapper":
        from mellow_tpu_torch.wrapper import MellowWrapper

        return MellowWrapper
    raise AttributeError(name)
