"""Process groups for the multi-GPU sweep (the part JAX's device discovery
plays for ``skelsplat_tpu/parallel/mesh.py``).

A multi-GPU run is one process per rank, started by ``torchrun``
(``torchrun --nproc_per_node=K -m skelsplat_tpu_torch.train ...
training.multichip=true``) or, for the tests and ``chip_smoke.py``, by
``spawn``. Each rank reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``), pins itself to ``cuda:LOCAL_RANK % device_count`` and
joins the group. The backend follows one rule: NCCL when every rank of
the host has a card of its own, gloo otherwise (CPU ranks, or several
ranks sharing a card, which NCCL refuses as "Duplicate GPU detected").
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket

import torch
import torch.distributed as dist

from skelsplat_tpu_torch import resolve_device

# how long a rank waits in a collective for the others before it fails
TIMEOUT = datetime.timedelta(minutes=10)


def world_size() -> int:
    """The process group's size, 1 where there is none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank, 0 where there is no process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def backend_for(device_type: str, local_world_size: int) -> str:
    """"nccl" when every one of the host's ``local_world_size`` ranks has a
    card of its own, "gloo" otherwise."""
    if device_type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK % device_count`` for a CUDA
    ``device`` (ranks beyond the host's cards share them), else
    ``device``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                        % torch.cuda.device_count())


def init_from_env(device="cuda") -> torch.device:
    """Join the process group torchrun's environment describes, once per
    process, on the backend ``backend_for`` picks. Returns this rank's
    device (``rank_device``), made the current CUDA device."""
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    n = int(os.environ["WORLD_SIZE"])
    backend = backend_for(dev.type, int(os.environ.get("LOCAL_WORLD_SIZE",
                                                       n)))
    extra = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=n,
                            timeout=TIMEOUT, **extra)
    return dev


@contextlib.contextmanager
def process_group(device="cuda"):
    """``init_from_env`` where torchrun's environment is set and no group
    exists yet, destroying the group it made on exit; yields this rank's
    device. Without that environment it yields ``resolve_device(device)``
    and makes no group."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        yield (rank_device(device) if dist.is_initialized()
               else resolve_device(device))
        return
    dev = init_from_env(device)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank_id: int, n: int, port: int, threads: int, rank_dir,
               fn, args):
    """One spawned rank: torchrun's environment for ``rank_id`` of ``n``,
    then ``fn(*args)``."""
    os.environ.update(RANK=str(rank_id), LOCAL_RANK=str(rank_id),
                      WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(threads)
    if rank_dir is not None:
        cwd = os.path.join(rank_dir, f"rank{rank_id}")
        os.makedirs(cwd, exist_ok=True)
        for fd, name in ((1, "stdout"), (2, "stderr")):
            with open(os.path.join(rank_dir, f"rank{rank_id}.{name}"),
                      "w") as f:
                os.dup2(f.fileno(), fd)
        os.chdir(cwd)
    fn(*args)


def spawn(n: int, fn, *args, rank_dir=None):
    """Run ``fn(*args)`` in ``n`` new local processes, ranks 0..n-1 of one
    group, as ``torchrun --nproc_per_node=n`` would, and wait for all of
    them; a rank that raises fails the call (and the others are stopped).
    ``fn`` must be importable by name (the ranks start from a fresh
    interpreter) and joins the group itself (``init_from_env`` or
    ``process_group``). The ranks share this process's intra-op threads.
    With ``rank_dir``, rank r runs in ``rank_dir/rank{r}`` and its
    standard output and error go to ``rank_dir/rank{r}.stdout`` and
    ``.stderr``, so what each rank prints or writes by a relative path
    stays apart."""
    threads = max(1, torch.get_num_threads() // n)
    torch.multiprocessing.start_processes(
        _rank_main, args=(n, free_port(), threads, rank_dir, fn, args),
        nprocs=n, join=True, start_method="spawn")
