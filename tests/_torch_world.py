"""Spawned gloo worlds for the port's multi-rank tests.

``run_world("module:function", n, **kw)`` starts ``n`` CPU processes, each
a rank of one gloo world (a file store in a temporary directory: no
network, no port), with one torch thread each.  Every rank calls
``function(rank, world, **kw)`` from ``module`` (a file under tests/ that
imports neither JAX nor the reference, so the ranks start fast) and its
return value comes back to the caller, one entry a rank.  ``World`` starts
the ranks and lets the caller work (the reference's results) before it
reads theirs.  Collectives time out after 120 s, and the caller gives up
on the whole world at ``timeout``, so a world whose ranks diverge fails
instead of hanging.

Run as a script, the file is the rank's entry point.
"""

import datetime
import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
COLLECTIVE_TIMEOUT_S = 120


class World:
    """An ``n``-rank gloo world running ``target`` (started at once; the
    caller works on while the ranks run, then reads :meth:`result`)."""

    def __init__(self, target: str, n: int, **kw):
        self.target, self.n = target, n
        self.tmp = tempfile.mkdtemp(prefix="torch_world_")
        with open(os.path.join(self.tmp, "args.pkl"), "wb") as f:
            pickle.dump((target, kw), f)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [SRC, HERE, os.environ.get("PYTHONPATH", "")]))
        self.errs = [open(os.path.join(self.tmp, f"err{r}.txt"), "w+")
                     for r in range(n)]
        self.t0 = time.monotonic()
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), self.tmp, str(r),
             str(n)], env=env, stdout=self.errs[r], stderr=subprocess.STDOUT)
            for r in range(n)]

    def result(self, timeout: float = 400.0):
        """Each rank's return value; raises with the failing rank's output
        when a rank fails, or when the world outlives ``timeout`` seconds
        from its start (every rank is stopped either way)."""
        procs = self.procs
        try:
            while True:
                codes = [p.poll() for p in procs]
                if (None not in codes or any(codes)
                        or time.monotonic() - self.t0 > timeout):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        try:
            bad = [r for r, p in enumerate(procs) if p.returncode]
            if bad:
                r = bad[0]
                self.errs[r].seek(0)
                raise RuntimeError(
                    f"rank {r} of {self.target} exited "
                    f"{procs[r].returncode}"
                    + (" (world timed out)"
                       if time.monotonic() - self.t0 > timeout else "")
                    + ":\n" + self.errs[r].read()[-6000:])
            out = []
            for r in range(self.n):
                with open(os.path.join(self.tmp, f"out{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            for e in self.errs:
                e.close()
            shutil.rmtree(self.tmp, ignore_errors=True)


def run_world(target: str, n: int, timeout: float = 400.0, **kw):
    """Each rank's return value of ``target`` in an ``n``-rank gloo
    world (:class:`World`)."""
    return World(target, n, **kw).result(timeout)


def _rank_main(tmp: str, rank: int, world: int) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        target, kw = pickle.load(f)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        mod, fn = target.split(":")
        res = getattr(importlib.import_module(mod), fn)(rank, world, **kw)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
