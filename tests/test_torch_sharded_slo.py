"""The SLO scheduler with its swap on the port's mesh: a (data=2, model=4)
gloo world of 8 spawned CPU ranks serves the twins of
tests/test_sharded_serving.py's ``test_sharded_slo_preemption_parity``
(:312, 'G') and ``test_sharded_recurrent_preemption_parity`` (:513, 'GM';
'GR' as a second case), on the reference's configs and weights (bridged).

An oversubscribed stream (10 requests on 4 slots over 8 blocks a data
shard, the protected class last, arrival order) preempts best-effort
slots, swaps them to host memory and resumes them mid-stream.  Every
unshed request's tokens equal the unpressured single-device serve's, the
port's and the reference's; the protected class completes; the trace of
every rank validates against its counters.

* A resume lands on another data shard than its swap-out (read from the
  ``swap_out`` and ``resume`` spans' pids): the payload travels from the
  ranks that swapped it out to those of the same model index on the
  resuming shard (every rank logs the digests of the bytes it sent and
  resumed from), and the request's tokens are still an uninterrupted
  run's.  With that transfer planted out (the resuming ranks keep the
  payload they built from their own stale rows) the bytes differ.  (The
  tiny model's greedy tokens repeat, so its tokens do not see stale
  state: the bytes are what the fault is caught by.)
* One rank's clock runs a million times fast past every best-effort
  deadline: the world neither hangs nor parts.  Rank 0's verdict holds
  everywhere: a fast clock elsewhere sheds nothing for the deadline, a
  fast clock on rank 0 sheds the same requests on every rank.

Every rank returns the same tokens, shed flags, counters and swap spans,
and they are those of the reference's own 2 x 4 mesh serve
(``_ref_mesh_runs``, 8 fake XLA devices in a child process).  The ranks (``_torch_runtime_ranks.slo_main``) serve while this process
runs the reference's and the single-device serves."""

import types

import jax
import numpy as np
import pytest

from repro.core import kv_compress as kv_ref
from repro.core import quantizer as quantizer_ref
from repro.core.request_cluster import Request as RequestRef
from repro.models.config import ModelConfig as ModelConfigRef
from repro.models.config import SSMConfig as SSMConfigRef
from repro.runtime.kv_pool import PagedKVConfig as PagedKVConfigRef
from repro.runtime.server import Server as ServerRef
from repro.runtime.server import ServerConfig as ServerConfigRef
from repro_torch import bridge
from repro_torch.runtime.server import Server

import _ref_mesh_runs
import _torch_ref
import _torch_runtime_ranks as ranks
from _torch_world import World

MODELS = ("G", "GM", "GR")
REF = types.SimpleNamespace(ServerConfig=ServerConfigRef,
                            KVCompressConfig=kv_ref.KVCompressConfig,
                            PagedKVConfig=PagedKVConfigRef)


def _unpressured(reqs, prompts, make):
    """Tokens of the stream, priorities dropped, over 48 blocks with no
    scheduler (``make(scfg)`` builds the Server)."""
    srv = make(dict(pool=48, fifo=True))
    cls = type(reqs[0])
    outs = srv.serve([cls(r.uid, r.prompt_len, r.max_new_tokens)
                      for r in reqs], prompts)
    return {o.uid: list(o.tokens) for o in outs}


@pytest.fixture(scope="module")
def runs():
    weights = {m: jax.tree.map(np.asarray, _torch_ref.ref_init_params(
        ranks.config(m, ModelConfigRef, SSMConfigRef), 0)) for m in MODELS}
    ref_mesh = _ref_mesh_runs.start("slo")
    world = World("_torch_runtime_ranks:slo_main", 8, weights=weights)
    ref, single = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quantizer_ref, "auto_scale", _torch_ref._auto_scale_exact)
        for m in MODELS:
            cfg = ranks.config(m, ModelConfigRef, SSMConfigRef)
            ref[m] = _unpressured(
                *ranks.slo_stream(RequestRef),
                lambda kw: ServerRef(cfg, ranks.server_config(REF, **kw),
                                     weights[m]))
    for m in MODELS:
        cfg = ranks.config(m)
        params = bridge.params_from_numpy(weights[m], cfg, "cpu")
        single[m] = _unpressured(
            *ranks.slo_stream(),
            lambda kw: Server(cfg, ranks.server_config(**kw), params,
                              device="cpu"))
    return {"ref": ref, "single": single, "ranks": world.result(),
            "ref_mesh": _ref_mesh_runs.result(ref_mesh)}


def _check(runs, name, want, rank=0):
    """Rank ``rank``'s serve ``name``: unshed tokens equal ``want``'s,
    the protected class complete and unshed, the trace valid."""
    toks, shed, st, _, problems, _ = runs["ranks"][rank][name]
    assert sorted(toks) == sorted(want)
    for uid, t in toks.items():
        if shed[uid]:
            assert uid < 6, uid         # only best-effort work is shed
            continue
        assert t == want[uid], (name, uid, t, want[uid])
    assert not any(shed[uid] for uid in range(6, 10))
    assert problems == [], problems
    assert st["n_data_shards"] == 2.0
    assert st["sched_shed_high"] == 0.0
    assert st["sched_backlog_end"] == 0.0
    assert st["pool_blocks_end"] == 0.0
    return st


def _moves(events):
    """(uid, swapped-out shard, resumed shard) of every resume, pairing
    each with the uid's last swap-out before it."""
    out, last = [], {}
    for name, pid, uid, _ in events:
        if name == "swap_out":
            last[uid] = pid
        elif name == "resume":
            out.append((uid, last[uid], pid))
    return out


def _deadline_sheds(events):
    return [uid for name, _, uid, why in events
            if name == "shed" and why == "deadline"]


def test_sharded_slo_preemption_parity(runs):
    """'G': preempted, swapped and resumed on the mesh; every unshed
    request's tokens equal the unpressured serve's on one device, the
    port's and the reference's."""
    assert runs["single"]["G"] == runs["ref"]["G"]
    st = _check(runs, "G", runs["ref"]["G"])
    assert st["sched_preemptions"] >= 1.0


@pytest.mark.parametrize("model", ["GM", "GR"])
def test_sharded_recurrent_preemption_parity(runs, model):
    """Recurrent state rides the slot snapshot through the swap on the
    mesh; every unshed request's tokens equal the unpressured serve's."""
    assert runs["single"][model] == runs["ref"][model]
    st = _check(runs, model, runs["ref"][model])
    assert st["sched_preemptions"] >= 1.0
    assert st["sched_swaps_in"] >= 1.0
    assert st["sched_swap_bytes"] == 0.0
    assert st["state_bytes_recurrent"] > 0
    assert st["kv_retired_recurrent"] == 0.0


def _transfer_problems(per_rank, name):
    """Each resume on another data shard than its swap-out, held against
    the payload moves every rank logged: one move a crossing on every
    rank (two data shards: each rank sends or receives), and the bytes
    the rank at (destination, m) resumed from are those the rank at
    (source, m) sent."""
    crossed = [(uid, a, b) for uid, a, b in _moves(per_rank[0][name][3])
               if a != b]
    at = {(c["coord"]["data"], c["coord"]["model"]): c[name][5]
          for c in per_rank}
    problems = []
    for (d, m), log in at.items():
        if [(a, b) for a, b, _, _ in log] != [(a, b) for _, a, b in crossed]:
            problems.append(f"rank ({d}, {m}) moves {log} for {crossed}")
    for k, (uid, src, dst) in enumerate(crossed):
        for m in range(4):
            sent, got = at[(src, m)][k][2], at[(dst, m)][k][3]
            if sent != got:
                problems.append(f"uid {uid} ({src} -> {dst}), model "
                                f"index {m}: sent {sent}, resumed {got}")
    return crossed, problems


@pytest.mark.parametrize("model", MODELS)
def test_schedule_equals_the_reference_mesh(runs, model):
    """The reference's own 2 x 4 mesh serve of the stream (8 fake XLA
    devices, in a child process): the same tokens, shed flags, sched_*
    and pool counters, and the same swap-outs and resumes, each on the
    same data shard (per-shard victims, the resume's headroom and its
    emptiest-shard slot)."""
    toks, shed, st, events = runs["ref_mesh"][model]
    got = runs["ranks"][0][model]
    assert got[0] == {int(k): v for k, v in toks.items()}
    assert got[1] == {int(k): v for k, v in shed.items()}
    assert got[2] == st
    assert got[3] == [tuple(e) for e in events]


def test_a_resume_crosses_data_shards(runs):
    """At least one request resumes on another data shard than the one it
    left, from the bytes its old shard's ranks swapped out, and its tokens
    are an uninterrupted run's.  With the transfer planted out (each
    resuming rank keeps its own stale rows) the bytes differ."""
    want = runs["ref"]["G"]
    toks, shed = runs["ranks"][0]["G"][:2]
    crossed, problems = _transfer_problems(runs["ranks"], "G")
    assert crossed
    assert problems == []
    for uid, _, _ in crossed:
        assert not shed[uid] and toks[uid] == want[uid], uid
    fault_crossed, fault_problems = _transfer_problems(runs["ranks"],
                                                       "G_fault")
    assert fault_crossed == crossed
    assert fault_problems


def test_every_rank_serves_the_same(runs):
    """One host engine, run SPMD: every rank's tokens, shed flags,
    counters and swap spans are rank 0's (the planted fault's too: the
    heads gathered over ``model`` and the tokens over ``data`` keep the
    ranks together even on stale bytes)."""
    per_rank = runs["ranks"]
    for name in (*MODELS, "G_fault", "G_blocking", "skew3", "skew0"):
        for r, got in enumerate(per_rank):
            assert got[name][:4] == per_rank[0][name][:4], (name, r)


def test_a_skewed_clock_neither_hangs_nor_parts_the_world(runs):
    """Blocking admission over 4 blocks a data shard defers best-effort
    admissions, which carry a deadline no true clock reaches.  Rank 3's
    clock past it: nothing is shed for it, and the serve is the
    deadline-free one; rank 0's clock past it: every rank sheds the same
    best-effort requests, and the rest finish with the unpressured
    tokens.  The world returned within its timeout either way."""
    base = runs["ranks"][0]["G_blocking"]
    skew3 = runs["ranks"][0]["skew3"]
    assert skew3[:2] == base[:2] and skew3[3] == base[3]
    assert skew3[2]["sched_sheds"] == base[2]["sched_sheds"]
    assert _deadline_sheds(skew3[3]) == []
    _check(runs, "G_blocking", runs["ref"]["G"])
    # rank 0's own trace mixes its fast clock's times: rank 1's is read
    _check(runs, "skew0", runs["ref"]["G"], rank=1)
    assert _deadline_sheds(runs["ranks"][1]["skew0"][3])
