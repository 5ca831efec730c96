"""Example scripts of the PyTorch port, one task each, as the JAX package's
``examples/``: ``python -m mellow_tpu_torch.examples.<name> [AUDIO1 AUDIO2]
[--device cpu]``. Without audio paths they write two seeded demo wavs of
their own."""
