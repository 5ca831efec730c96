"""Multi-device runs over ``torch.distributed`` (``mellow_tpu/parallel/``):
``multihost`` joins the process group, ``sharding`` builds the (data,
model) mesh and shards the parameters, ``tensor`` holds the collectives of
tensor parallelism, ``dryrun`` runs the sharded paths on CPU ranks.

A mesh wrapper's ``generate`` and ``generate_stream`` are collective. Rank
0 broadcasts each call (``exchange``); ``follow(wrapper)`` is the loop of
every other rank, which runs rank 0's calls until rank 0 calls
``stop(wrapper)``, so that one process (the server, the CLI,
``serving.BatchingEngine``) drives every card.

Between calls the other ranks wait on the group's key-value store
(``multihost.next_control_key``), not in a collective: a rank 0 that gets
no request for longer than the process group's timeout trips no timeout
and no watchdog. Only once rank 0 has set the call's key do the ranks
enter its collectives."""

import datetime

import torch.distributed as dist

from mellow_tpu_torch.parallel import multihost

# A wait for rank 0's next call ends after this long and waits again; a
# lost rank 0 (the store's server) raises at once.
WAIT_CHUNK = datetime.timedelta(hours=1)


def exchange(msg):
    """Rank 0's ``msg`` on every rank of the world (``broadcast_object_list``,
    on the process's card under NCCL); other ranks pass None and wait
    without a timeout for rank 0's call."""
    store, key = multihost.next_control_key()
    if dist.get_rank() == 0:
        store.set(key, b"1")
        if key != "0":  # every rank has passed the previous key: its broadcast needed them all
            store.delete_key(str(int(key) - 1))
    else:
        while True:
            try:
                store.wait([key], WAIT_CHUNK)
                break
            except dist.DistStoreError:  # the chunk's timeout (a lost server raises DistNetworkError)
                continue
    box = [msg]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def follow(wrapper) -> int:
    """On a rank other than 0 of a mesh wrapper: run each ``generate`` and
    ``generate_stream`` that rank 0 calls, until ``stop``; returns the
    number of calls run."""
    if wrapper.mesh is None or dist.get_rank() == 0:
        raise ValueError("follow() runs on the ranks other than 0 of a mesh wrapper")
    calls = 0
    while True:
        msg = exchange(None)
        if msg is None:
            return calls
        out = wrapper._mesh_run(msg)
        if msg[0] == "generate_stream":
            for _ in out:
                pass
        calls += 1


def stop(wrapper) -> None:
    """On rank 0 of a mesh wrapper: end the other ranks' ``follow``."""
    if wrapper.mesh is None or dist.get_rank() != 0:
        raise ValueError("stop() runs on rank 0 of a mesh wrapper")
    exchange(None)
