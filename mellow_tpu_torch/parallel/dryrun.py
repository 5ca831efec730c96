"""Multi-rank dry run on the host's CPU (``__graft_entry__.dryrun_multichip``).

The JAX package runs its sharded paths on virtual CPU devices in one
process; the port runs them on ``n`` processes joined by gloo, one per
rank, on the host's cores. ``spawn`` starts such a world around any
function (``"module:function"``, called on every rank with the same
arguments, each rank's return value handed back to the caller) with a
timeout on the spawn and on every collective of the group, so a rank that
misses a collective fails the run in seconds instead of hanging it.

``dryrun_multichip(n)`` runs the sharded train step over ``mesh_grids(n)``
at the dry run's tiny configuration (``DRYRUN``: its heads shard at
``tp=3``, its MLP and vocabulary at ``tp=2`` and ``tp=3``) and checks that
the losses agree across meshes, then that greedy ``generate`` on the
pure-DP mesh and on a TP mesh gives the unsharded tokens. The steps run
with no generator: the draws are per data index (``loop.step_generator``),
so meshes with other data axes draw otherwise. ``device="cuda"`` runs the
same ranks one a card, joined by NCCL (``n`` cards on one host).

    python -m mellow_tpu_torch.parallel.dryrun 6          # CPU ranks, gloo
    python -m mellow_tpu_torch.parallel.dryrun 4 cuda     # four cards, NCCL
"""

from __future__ import annotations

import importlib
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import List

import numpy as np

from mellow_tpu_torch.config import HTSATConfig, LlamaConfig, MellowConfig, register_config

# The dry run's tiny shapes (``__graft_entry__._dryrun_impl``).
DRYRUN = MellowConfig(
    name="dryrun_tiny",
    encoder=HTSATConfig(embed_dim=8, out_emb=64),
    decoder=LlamaConfig(vocab_size=768, hidden_size=96, intermediate_size=192, num_layers=2, num_heads=6,
                        num_kv_heads=3, head_dim=16),
    d_proj=96, text_tokenization_len=8, prefix_length=268,
)
register_config(DRYRUN.name, DRYRUN)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def mesh_grids(n: int) -> List[tuple]:
    """The (n, tp) meshes a dry run over ``n`` ranks exercises: pure DP; tp=2
    (the MLP and vocabulary sharded, the attention replicated) when 2
    divides n; tp=3 (the KV heads sharded too) when 3 divides n. Each
    covers the whole world (``sharding.make_mesh``)."""
    return [(n, tp) for tp in (1, 2, 3) if n % tp == 0 and (tp == 1 or n > 1)]


def free_port() -> int:
    """A free TCP port on the loopback, for a process group's address."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """The processes of one ``spawn``; ``wait`` returns their results."""

    def __init__(self, procs, workdir: str, timeout: float):
        self.procs, self.workdir = procs, workdir
        self.deadline = time.monotonic() + timeout

    def _tail(self, r: int) -> str:
        with open(os.path.join(self.workdir, f"rank{r}.log"), errors="replace") as f:
            return f"--- rank {r} ---\n" + f.read()[-3000:]

    def wait(self) -> list:
        """Every rank's return value, in rank order. Raises (after killing
        the world) as soon as a rank fails, or at the timeout."""
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank(s) {failed} failed:\n" + "\n".join(self._tail(r) for r in failed))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > self.deadline:
                    raise TimeoutError("ranks still running at the timeout:\n"
                                       + "\n".join(self._tail(r) for r, c in enumerate(codes) if c is None))
                time.sleep(0.05)
            out = []
            for r in range(len(self.procs)):
                with open(os.path.join(self.workdir, f"rank{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            self.close()

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        shutil.rmtree(self.workdir, ignore_errors=True)


def spawn(n: int, target: str, *args, timeout: float = 120.0, group_timeout: float = 30.0,
          device: str = "cpu") -> Ranks:
    """Start ``n`` ranks, each calling ``target`` (``"module:function"``,
    importable from the repository's root) with ``args``; returns at once.
    ``device="cpu"``: CPU ranks joined by gloo; ``"cuda"``: rank r on card
    r, joined by NCCL. ``timeout`` bounds the whole run (``wait``),
    ``group_timeout`` every collective; each rank runs one torch thread."""
    workdir = tempfile.mkdtemp(prefix="mellow_ranks_")
    with open(os.path.join(workdir, "job.pkl"), "wb") as f:
        pickle.dump({"target": target, "args": args, "group_timeout": group_timeout, "device": device}, f)
    port = free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([_REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        log = open(os.path.join(workdir, f"rank{r}.log"), "w")
        procs.append(subprocess.Popen([sys.executable, "-m", "mellow_tpu_torch.parallel.dryrun", "--rank",
                                       workdir], cwd=_REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return Ranks(procs, workdir, timeout)


def _rank_main(workdir: str) -> int:
    import torch

    from mellow_tpu_torch.parallel import multihost

    with open(os.path.join(workdir, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    try:
        multihost.initialize(device=job["device"], timeout=job["group_timeout"])
        module, name = job["target"].split(":")
        result = getattr(importlib.import_module(module), name)(*job["args"])
        with open(os.path.join(workdir, f".rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        os.replace(os.path.join(workdir, f".rank{rank}.pkl"), os.path.join(workdir, f"rank{rank}.pkl"))
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # no teardown of the group, which could wait on the ranks that ``wait`` kills
    multihost.shutdown()
    return 0


def dryrun_rank(n: int, device: str = "cpu") -> dict:
    """One rank of ``dryrun_multichip``: the train step's loss on each mesh,
    and the DP and TP greedy tokens against the unsharded ones."""
    import torch
    import torch.distributed as dist

    from mellow_tpu_torch.models import mellow as mellow_model
    from mellow_tpu_torch.models.params import params_from_jax
    from mellow_tpu_torch.parallel import sharding
    from mellow_tpu_torch.train import step as tstep

    cfg = DRYRUN
    B = 2 * n
    rng = np.random.RandomState(0)
    batch = {
        "audio1": (rng.randn(B, 320000) * 0.1).astype(np.float32),
        "audio2": (rng.randn(B, 320000) * 0.1).astype(np.float32),
        "text_ids": rng.randint(2, 700, (B, 8)).astype(np.int32),
        "answer_ids": rng.randint(2, 700, (B, 6)).astype(np.int32),
        "answer_mask": np.ones((B, 6), np.float32),
    }
    tree = mellow_model.init_params(cfg, 0)
    if device == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False  # fp32 parity, as the wrapper sets it
        torch.backends.cudnn.allow_tf32 = False
    losses = {}
    for n_mesh, tp in mesh_grids(n):
        mesh = sharding.make_mesh(n_mesh, tp=tp)
        opt = tstep.make_optimizer()
        params = sharding.shard_params(params_from_jax(tree, device), mesh, cfg)
        state = tstep.init_train_state(params, opt)
        state, m = tstep.train_step(state, cfg, opt, batch, None, mesh=mesh)
        loss = float(m["loss"])
        if not np.isfinite(loss) or state.step != 1:
            raise RuntimeError(f"dp={n_mesh // tp} tp={tp}: loss {loss} after step {state.step}")
        losses[f"{n_mesh // tp}x{tp}"] = loss
        if dist.get_rank() == 0:
            print(f"[dryrun] dp={n_mesh // tp} tp={tp} sharded train step OK: loss={loss:.6f}, "
                  f"grad_norm={float(m['grad_norm']):.6f}", flush=True)
    vals = list(losses.values())
    if not all(abs(v - vals[0]) <= 1e-5 * max(1.0, abs(vals[0])) for v in vals):
        raise RuntimeError(f"the losses disagree across meshes: {losses}")

    full = params_from_jax(tree, device)
    a1, ids = (torch.from_numpy(batch[k]).to(device) for k in ("audio1", "text_ids"))
    box = [None]
    if dist.get_rank() == 0:
        box = [mellow_model.generate_tokens(full, cfg, a1, a1, ids, max_len=4).tokens.cpu()]
    dist.broadcast_object_list(box, src=0)
    tokens = {}
    for n_mesh, tp in mesh_grids(n)[:1] + mesh_grids(n)[-1:]:
        mesh = sharding.make_mesh(n_mesh, tp=tp)
        params = sharding.shard_params(full, mesh, cfg)
        res = mellow_model.generate_tokens_sharded(params, cfg, a1, a1, ids, mesh=mesh, max_len=4,
                                                   tp=sharding.decoder_tp(mesh, cfg))
        if not torch.equal(res.tokens.cpu(), box[0]):
            raise RuntimeError(f"tp={tp}: the sharded tokens {res.tokens.tolist()} differ from the unsharded "
                               f"{box[0].tolist()}")
        tokens[f"{n_mesh // tp}x{tp}"] = res.tokens.tolist()
        if dist.get_rank() == 0:
            print(f"[dryrun] dp={n_mesh // tp} tp={tp} generate OK: tokens match unsharded", flush=True)
    return {"losses": losses, "tokens": tokens}


def dryrun_multichip(n_devices: int, timeout: float = 600.0, device: str = "cpu") -> dict:
    """Run the dry run on ``n_devices`` ranks (CPU ranks, or one card each
    with ``device="cuda"``); raises on a failure. Returns rank 0's losses
    and tokens."""
    out = spawn(n_devices, "mellow_tpu_torch.parallel.dryrun:dryrun_rank", n_devices, device, timeout=timeout,
                group_timeout=min(timeout, 300.0), device=device).wait()
    print(f"[dryrun] {n_devices} {device} ranks: losses agree across meshes: {out[0]['losses']}")
    print(f"[dryrun] greedy generate on {sorted(out[0]['tokens'])} equals the unsharded tokens")
    return out[0]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(_rank_main(sys.argv[2]))
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 6, device=sys.argv[2] if len(sys.argv) > 2 else "cpu")
