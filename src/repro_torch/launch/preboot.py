"""Rank bring-up for CLI entry points that take ``--mesh DxM`` (port of
``repro.launch.preboot``).

The reference forces fake XLA host devices before JAX starts, so that one
process can hold a mesh.  The port's mesh is one process per rank, so its
counterpart makes the ranks exist: :func:`start_mesh_ranks` peeks at
``--mesh`` in the raw argv and, unless the process already is a rank (under
``torchrun``: RANK and WORLD_SIZE set), starts D × M local ranks of the
same module with the same arguments and waits for them.  Rank 0 prints;
a failing rank fails the run (the others are stopped).  Each rank then
joins the world with :func:`init_world`: gloo for the CPU, NCCL for CUDA,
where a world larger than the visible card count is refused (NCCL puts one
rank on each card).

Importing this module starts nothing; malformed specs are left for
``launch.mesh.parse_mesh_spec`` to reject with a proper error.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# a rank that waits longer than this on a collective fails instead of
# hanging (ranks whose host decisions diverge never meet again)
COLLECTIVE_TIMEOUT_S = 120


def _flag(argv: Sequence[str], name: str) -> Optional[str]:
    val = None
    for i, a in enumerate(argv):
        if a.startswith(name + "="):
            val = a.split("=", 1)[1]
        elif a == name and i + 1 < len(argv):
            val = argv[i + 1]
    return val


def mesh_ranks(argv: Sequence[str]) -> Optional[int]:
    """The rank count ``--mesh dxm`` in ``argv`` asks for, or None (no
    flag, or a spec that does not parse)."""
    spec = _flag(argv, "--mesh")
    if not spec:
        return None
    try:
        need = 1
        for p in spec.lower().split("x"):
            need *= int(p)
    except ValueError:
        return None
    return need


def is_rank() -> bool:
    """True in a process that ``torchrun`` or :func:`start_mesh_ranks`
    started as a rank of a world."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def check_cuda_world(world: int) -> None:
    """NCCL puts one rank on each card: refuse a world larger than the
    visible card count."""
    cards = torch.cuda.device_count()
    if world > cards:
        raise ValueError(
            f"a CUDA mesh of {world} ranks needs {world} cards (NCCL puts "
            f"one rank on each) but {cards} are visible")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_mesh_ranks(argv: Sequence[str], module: str) -> Optional[int]:
    """Run ``python -m module argv`` as the ranks of the world
    ``--mesh`` asks for, and return the run's exit code; None when there
    is nothing to start (no ``--mesh``, or this process already is a
    rank), and the caller goes on in-process.

    The ranks find each other on 127.0.0.1 (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT, as ``torchrun`` sets them).  The first rank
    to fail stops the others and gives the run its exit code.  Without
    ``--device`` the ranks run on CUDA, as the entry points do."""
    need = mesh_ranks(argv)
    if need is None or is_rank():
        return None
    device = _flag(argv, "--device") or "cuda"
    if torch.device(device).type == "cuda":
        try:
            check_cuda_world(need)
        except ValueError as e:
            print(f"{module}: error: --mesh: {e}", file=sys.stderr)
            return 2
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(need),
               LOCAL_WORLD_SIZE=str(need))
    procs = [subprocess.Popen([sys.executable, "-m", module, *argv],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(need)]
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c]
            if failed or None not in codes:
                return failed[0] if failed else 0
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def init_world(device) -> None:
    """Join the world the environment names (``torchrun``'s variables, or
    :func:`start_mesh_ranks`'s): gloo when ``device`` is the CPU, NCCL on
    CUDA, where this rank takes card LOCAL_RANK.  Nothing when a world is
    already up or the environment names none."""
    if dist.is_initialized() or not is_rank():
        return
    dev = torch.device(device)
    world = int(os.environ["WORLD_SIZE"])
    backend = "gloo"
    if dev.type == "cuda":
        check_cuda_world(world)
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        backend = "nccl"
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(
                                seconds=COLLECTIVE_TIMEOUT_S))


def is_rank_zero() -> bool:
    """True outside a world, and on its rank 0."""
    return not dist.is_initialized() or dist.get_rank() == 0


def leave_world() -> None:
    """Tear down the world this process joined, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()
