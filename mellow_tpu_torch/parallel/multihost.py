"""Process-group set-up for multi-device runs (``mellow_tpu/parallel/multihost.py``).

The JAX package drives every device from one process; the port runs one
process per device (``torchrun``, SPMD) joined by ``torch.distributed``.
Typical entry point, launched as ``torchrun --nproc_per_node=N script.py``:

    from mellow_tpu_torch.parallel import multihost, sharding
    multihost.initialize()                    # reads torchrun's environment
    mesh = sharding.make_mesh()               # (data, model) over every rank
    wrapper = MellowWrapper(..., mesh=mesh)   # parameters sharded at load

The backend is NCCL on the card; gloo serves only an explicit
``device="cpu"`` (the tests, on the host's cores). Nothing falls back.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_store = None  # the key-value store of the group ``initialize`` joined, under this package's prefix
_messages = 0  # control messages counted on it so far


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: str = "cuda",
    timeout: float = 600.0,
) -> dict:
    """Join the process group (idempotent) and return JAX's summary dict.

    ``coordinator_address`` is ``host:port`` of rank 0; with no argument the
    address, world size and rank come from torchrun's ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. With neither, the process
    stays single-process: world 1, nothing joined. On the card
    (``device="cuda"``) the backend is NCCL on ``cuda:LOCAL_RANK`` (the
    rank modulo the visible cards when ``LOCAL_RANK`` is unset), and the
    call raises where NCCL is missing; ``device="cpu"`` takes gloo.
    ``timeout`` (seconds) bounds every collective of the group, so a rank
    that misses one fails instead of hanging. The group's key-value store
    (a ``TCPStore`` that rank 0 serves) also carries the control messages
    of ``parallel.follow``, which no collective's timeout bounds."""
    global _store, _messages
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not dist.is_initialized():
        env = os.environ
        if coordinator_address is None and all(k in env for k in _ENV):
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
            num_processes = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
            process_id = int(env["RANK"]) if process_id is None else process_id
        if coordinator_address is not None:
            if num_processes is None or process_id is None:
                raise ValueError("a coordinator address needs num_processes and process_id")
            if device == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError("device='cuda' but CUDA is not available")
                if not dist.is_nccl_available():
                    raise RuntimeError("device='cuda' needs NCCL, which this torch lacks")
                local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
                torch.cuda.set_device(local)
            host, port = coordinator_address.rsplit(":", 1)
            wait = datetime.timedelta(seconds=timeout)
            store = dist.TCPStore(host.strip("[]"), int(port), num_processes, is_master=process_id == 0,
                                  timeout=wait)
            dist.init_process_group(
                backend="nccl" if device == "cuda" else "gloo",
                store=store,
                world_size=num_processes,
                rank=process_id,
                timeout=wait,
            )
            _store, _messages = dist.PrefixStore("mellow_tpu_torch/control/", store), 0
    joined = dist.is_initialized()
    count = dist.get_world_size() if joined else 1
    return {
        "process_index": dist.get_rank() if joined else 0,
        "process_count": count,
        "local_devices": 1,  # one device per process
        "global_devices": count,
    }


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def next_control_key() -> tuple:
    """(the joined group's key-value store, the key of the next control
    message): every rank counts the messages alike, so the key that rank 0
    sets is the one the others wait for. Raises unless ``initialize``
    joined the group."""
    global _messages
    if _store is None or not dist.is_initialized():
        raise RuntimeError("no process group joined by parallel.multihost.initialize()")
    _messages += 1
    return _store, str(_messages - 1)


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    global _store
    _store = None
    if dist.is_initialized():
        dist.destroy_process_group()
