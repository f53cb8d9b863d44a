"""The process group and device mesh of the port's parallel layer.

Port of `strling_tpu.parallel.mesh` onto torch.distributed. The reference has
no in-process parallelism at all (SURVEY.md §2: per-sample /
per-chromosome fan-out via bpipe, files as the only transport). Here:

- read-stream data parallelism ("data" dim): batches of reads sharded over
  ranks for the extract scan; per-rank fragment-length and repeat-unit
  histograms combined with all_reduce;
- locus-space sharding ("locus" dim): (tid, repeat)-bucketed evidence
  distributed over ranks for clustering/genotyping; candidate bounds
  combined with all_gather.

One process is one rank is one device (JAX's "local devices of a process"
is 1 throughout). Backend rule (`backend_rule`), printed on stderr when the
group starts: NCCL when the device is cuda and every rank on the host has a
card of its own (four ranks on four cards: rank r on cuda:r); Gloo when the
device is cpu, or when ranks share a card (NCCL refuses two ranks on one
GPU). Every collective's tensors live on the group's device (`group_device`:
the rank's card under NCCL, the CPU under Gloo); the rank's own device
(`rank_device`) is where its scans and sorts run.
"""

from __future__ import annotations

import atexit
import datetime
import os
import sys
import weakref

import numpy as np
import torch
import torch.distributed as dist


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


#: (weak reference to the default group, device kind) of the group
#: init_distributed started or was given. Weak: a group kept alive past
#: destroy_process_group keeps its Gloo workers too, and a worker that drops
#: the last reference to a tensor while the interpreter shuts down aborts
#: the process ("terminate called without an active exception").
_started: tuple | None = None


def _started_kind() -> str | None:
    """The device kind recorded for the current default group, if any."""
    group = _started[0]() if _started else None
    if group is None or group is not dist.group.WORLD:
        return None
    return _started[1]


def rank_device(device: str | None = None) -> torch.device:
    """This rank's device: cuda:LOCAL_RANK % device_count, or cpu. `device`
    is "cuda" or "cpu"; None: the kind init_distributed was given for this
    group, else the rank's card (a group started elsewhere runs on the card
    unless the caller asks for the CPU)."""
    if device is None:
        device = _started_kind() or "cuda"
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for this rank: pass device "
                           "'cpu' (or start the group with init_distributed"
                           "('cpu'))")
    return torch.device("cuda", _local_rank() % torch.cuda.device_count())


def backend_rule(device: str, local_world: int,
                 n_cards: int) -> tuple[str, str]:
    """(backend, why) for a group of `local_world` ranks on this host with
    `n_cards` cards: NCCL when the device is cuda and every rank has a card
    of its own, else Gloo."""
    if device == "cpu":
        return "gloo", "device cpu"
    if local_world <= n_cards:
        return "nccl", (f"each of the {local_world} ranks on this host has "
                        "its own card")
    return "gloo", (f"{local_world} ranks share {n_cards} card(s): NCCL "
                    "refuses two ranks on one GPU; collectives on the CPU")


def group_device() -> torch.device:
    """Where the default group's collectives take their tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def init_distributed(device: str = "cuda", init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None,
                     timeout: float | None = None) -> torch.device:
    """Start the default process group (once per process) and return this
    rank's device. `device` is "cuda" (needs a card) or "cpu".

    The rank and world come from the arguments, else from torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR/MASTER_PORT, read through `init_method` "env://" when none
    is given). Without either the process runs as a world of one on an
    in-memory store, as the JAX package's --distributed does with one
    process. `timeout` (seconds) bounds the group's collectives and its
    rendezvous; None keeps torch.distributed's default."""
    global _started
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu for a Gloo group on the CPU)")
    if dist.is_initialized():
        # a group started elsewhere: its ranks' default device is `device`
        if _started_kind() is None:
            _started = (weakref.ref(dist.group.WORLD), device)
        return rank_device(device)
    env = os.environ
    from_env = "RANK" in env and "WORLD_SIZE" in env
    if rank is None:
        rank = int(env["RANK"]) if from_env else 0
    if world_size is None:
        world_size = int(env["WORLD_SIZE"]) if from_env else 1
    if init_method is None and from_env:
        init_method = "env://"
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    n_cards = torch.cuda.device_count() if device == "cuda" else 0
    backend, why = backend_rule(device, local_world, n_cards)
    if device == "cuda":
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    kw = {} if timeout is None else {"timeout": datetime.timedelta(
        seconds=timeout)}
    if init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, **kw)
    _started = (weakref.ref(dist.group.WORLD), device)
    # a group left to the interpreter's exit can abort the process while its
    # threads are still joinable (and NCCL warns of leaked resources)
    atexit.register(_destroy)
    print(f"[strling] rank {rank} of {world_size}: backend {backend} "
          f"({why}), device {dev}", file=sys.stderr)
    return dev


def _destroy():
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(n: int | None = None, locus_axis: bool = False):
    """The device mesh over the group's `n` ranks (default: all): dims
    ("data",), or ("data", "locus") of shape (n/2, 2) when `locus_axis`,
    n >= 4 and n is even, the JAX package's rule. Rank r sits at
    (r // 2, r % 2) of the 2-D mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    n = world if n is None else n
    if n != world:
        raise ValueError(f"a mesh spans the whole group: {n} != {world} ranks")
    kind = group_device().type
    if locus_axis and n >= 4 and n % 2 == 0:
        return init_device_mesh(kind, (n // 2, 2),
                                mesh_dim_names=("data", "locus"))
    return init_device_mesh(kind, (n,), mesh_dim_names=("data",))


def gather_blobs(blob: bytes) -> list[bytes]:
    """Gather one bytes blob from every rank, in rank order (a padded uint8
    all_gather on the group's device)."""
    world = dist.get_world_size()
    if world == 1:
        return [blob]
    dev = group_device()
    n = torch.tensor([len(blob)], dtype=torch.int64, device=dev)
    lens = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(lens, n)
    lens = [int(t.item()) for t in lens]
    pad = np.zeros(max(1, max(lens)), np.uint8)
    pad[:len(blob)] = np.frombuffer(blob, np.uint8)
    mine = torch.from_numpy(pad).to(dev)
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine)
    return [parts[r][:lens[r]].cpu().numpy().tobytes() for r in range(world)]


def broadcast_blob(blob: bytes | None, src: int = 0) -> bytes:
    """`blob` of rank `src` on every rank (others pass None)."""
    if dist.get_world_size() == 1:
        return blob
    dev = group_device()
    n = torch.tensor([len(blob) if dist.get_rank() == src else 0],
                     dtype=torch.int64, device=dev)
    dist.broadcast(n, src)
    if dist.get_rank() == src:
        buf = torch.from_numpy(np.frombuffer(blob, np.uint8).copy()).to(dev)
    else:
        buf = torch.empty(int(n.item()), dtype=torch.uint8, device=dev)
    if buf.numel():
        dist.broadcast(buf, src)
    return blob if dist.get_rank() == src else buf.cpu().numpy().tobytes()
