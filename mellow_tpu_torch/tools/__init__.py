"""Offline tools: the checkpoint converter and exporter (the port's copies
of ``mellow_tpu/tools/convert_ckpt.py`` and ``export_ckpt.py``)."""
