"""``python -m repro_torch.launch.serve --device cpu --mesh 2x2`` against
``python -m repro.launch.serve --mesh 2x2`` (four fake XLA host devices,
its own preboot), both in subprocesses at the reduced qwen3-4b's own bf16
with weights from the same seed: every printed line equal but for its
timing fields (the lines count requests, tokens, launches and positions,
which the schedule alone sets), for blocking exact KV and for paged
chunked clustered KV (its peak KV bytes count every kv head, though a
rank holds half of them), the reduced qwen2-moe chunked (its routed
experts 2 a rank), and paged chunked with ``--priority-demo`` (the SLO
scheduler's counters and its shed uids) and with ``--persist-templates``
(the warm re-serve's store hits, ``tokens identical: True``).  The port's launcher starts the four gloo ranks
itself and rank 0 prints.  Also: a rank that fails fails the run at once,
with its exit code, and the waiting ranks are stopped."""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from repro_torch.launch import preboot

import _torch_ref  # noqa: F401  (one torch thread, the JAX cache)
from _serve_lines import mask

ROOT = Path(__file__).resolve().parents[1]
ARGV = ["--reduced", "--requests", "8", "--max-new", "4", "--mesh", "2x2"]
QWEN3 = ["--arch", "qwen3-4b"]
PAGED = QWEN3 + ["--paged", "--prefill-chunk", "16", "--kv-clusters", "8",
                 "--keep-recent", "16", "--refresh-every", "8"]
CASES = {
    "exact": QWEN3,
    "paged": PAGED,
    # 8 routed experts on 4 ranks: 2 a rank, the sharded dispatch
    "moe": ["--arch", "qwen2-moe-a2.7b", "--prefill-chunk", "16"],
    # the SLO scheduler over a pool tightened below the slots' rings, and
    # the template store served twice, per data shard
    "priority": PAGED + ["--priority-demo"],
    "templates": PAGED + ["--persist-templates"],
}


def _start(module, argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "XLA_FLAGS"):
        env.pop(k, None)
    return subprocess.Popen([sys.executable, "-m", module, *argv], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def lines():
    """{case: (reference lines, port lines)}, all four runs at once."""
    procs = {case: (_start("repro.launch.serve", ARGV + flags),
                    _start("repro_torch.launch.serve",
                           ARGV + flags + ["--device", "cpu"]))
             for case, flags in CASES.items()}
    out = {}
    for case, pair in procs.items():
        got = []
        for p in pair:
            try:
                stdout, stderr = p.communicate(timeout=240)
            finally:
                p.kill()
            assert p.returncode == 0, stderr[-4000:]
            got.append([ln for ln in stdout.splitlines()
                        if ln.startswith("[serve]")])
        out[case] = tuple(got)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_cli_lines_equal_reference(lines, case):
    want, got = lines[case]
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert mask(g) == mask(w)
    assert "[serve] mesh 2x2: slots over data=2, heads over model=2" in got
    assert any(g.startswith("[serve] per-data-shard slot waste: ")
               for g in got)
    if case == "priority":
        assert any(g.startswith("[serve] SLO scheduling: ") for g in got)
    if case == "templates":
        assert any(g.startswith("[serve] warm re-serve: ")
                   and g.endswith("tokens identical: True") for g in got)


def test_a_failing_rank_fails_the_run(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(ROOT / "tests"), os.environ.get("PYTHONPATH", "")]))
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    t0 = time.monotonic()
    code = preboot.start_mesh_ranks(["--mesh", "2x2", "--device", "cpu"],
                                    "_torch_rank_fail")
    assert code == 3
    assert time.monotonic() - t0 < 60
