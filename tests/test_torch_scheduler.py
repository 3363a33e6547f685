"""The port's SLO scheduler against the reference's.

``repro_torch.runtime.scheduler`` is a host copy of the reference module.
tests/test_scheduler.py's unit tests run on both packages (one
parametrised twin each), and the same seeded operation sequences (swap
out, pick a victim, peek, hold, resume, shed) drive a reference and a
port scheduler, whose every decision and stat must agree.  The pool's
resume half (``release_slot``, ``readopt``, ``resume_demand``) and the
priority-class planning are held against the reference's, the swap's
device half round-trips a slot bit for bit (tests/_torch_swap.py), and a
Hypothesis state machine drives the port's ``BlockPool`` and
``SLOScheduler`` together (the twin of tests/test_properties.py's
``TestSchedulerSwapProperties``).

Engine level: ``TestEnginePreemption``'s five scenarios on TINY (f32),
parameters carried over by ``bridge``: a tight pool with late
high-priority requests, chunked and blocking; an overloaded pool that
must shed; priority admission; and expired best-effort deadlines; and
one more, prefix sharing under preemption, where resumes re-adopt the
blocks the prefix cache kept.  The port's tokens, ``shed`` flags and
every ``sched_*`` counter equal the reference ``Server``'s, and the port keeps the reference's invariants:
preemption happened and resumed, the protected class completes in full,
and every non-shed request's tokens equal an uninterrupted run's.  Each
reference scenario is served once a module (``_Runs``)."""

import dataclasses
import types

import jax
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from _torch_ref import ref_init_params
from repro.core import kv_compress
from repro.core import request_cluster as rc_ref
from repro.models import transformer as tfm
from repro.models.config import ModelConfig
from repro.runtime import kv_pool as kv_pool_ref
from repro.runtime import scheduler as sched_ref
from repro.runtime.prefix_cache import PrefixShareConfig
from repro.runtime.server import Server, ServerConfig
from repro_torch import bridge
from repro_torch.core import kv_compress as kv_t
from repro_torch.core import request_cluster as rc_t
from repro_torch.models.config import ModelConfig as ModelConfigT
from repro_torch.runtime import kv_pool as kv_pool_t
from repro_torch.runtime import prefix_cache as pc_t
from repro_torch.runtime import scheduler as sched_t
from repro_torch.runtime.server import Server as ServerT
from repro_torch.runtime.server import ServerConfig as ServerConfigT
from _torch_swap import swap_round_trip, tiny

REF = types.SimpleNamespace(pool=kv_pool_ref, sched=sched_ref, rc=rc_ref)
PORT = types.SimpleNamespace(pool=kv_pool_t, sched=sched_t, rc=rc_t)
PKGS = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])

_TINY_KW = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
                pad_vocab_multiple=16, dtype="float32")
TINY, TINY_T = ModelConfig(**_TINY_KW), ModelConfigT(**_TINY_KW)
CCFG = kv_compress.KVCompressConfig(n_clusters=8, iters=4, keep_recent=16,
                                    refresh_every=8)
SCHED_KEYS = ("sched_deferrals", "sched_preemptions", "sched_swaps_out",
              "sched_swaps_in", "sched_sheds", "sched_shed_high",
              "sched_swapped_peak_blocks", "sched_readopted_blocks",
              "sched_reuploaded_blocks", "sched_swap_bytes",
              "sched_backlog_end")


# ---------------------------------------------------------------------------
# unit: SLOScheduler policy, on both packages
# ---------------------------------------------------------------------------


def _rec(pkg, uid, priority, seq=0, n_blocks=1, hold=False):
    return pkg.sched.SwapRecord(
        uid=uid, priority=priority, pos=4, cur=1, fed=4, since_tok=0, cov=0,
        max_new_tokens=4, deadline_ms=0.0, held={0: (uid, 0)}, snap=None,
        tails=None, epoch=0, seq=seq, n_blocks_swapped=n_blocks, hold=hold)


@PKGS
def test_pick_victim_strictly_lower_and_cheapest(pkg):
    slo = pkg.sched.SLOScheduler(pkg.sched.SLOConfig(), 4)
    cands = [(0, 3, 0), (0, 1, 1), (1, 0, 2)]
    assert slo.pick_victim(cands, 1) == 1
    assert slo.pick_victim(cands, 0) is None
    assert slo.pick_victim([(1, 2, 0), (1, 1, 3)], 1) is None
    assert slo.pick_victim([(1, 2, 0), (1, 1, 3)], 2) == 3
    assert slo.pick_victim([], 5) is None


@PKGS
def test_backlog_resume_order_and_holds(pkg):
    slo = pkg.sched.SLOScheduler(pkg.sched.SLOConfig(), 4)
    a, b, c = _rec(pkg, 0, 0), _rec(pkg, 1, 1), _rec(pkg, 2, 1)
    for r in (a, b, c):
        slo.record_swap(r)
    assert slo.peek_resume() is b
    b.hold = True
    assert slo.peek_resume() is c
    c.hold = True
    assert slo.peek_resume() is a
    a.hold = True
    assert slo.peek_resume() is None
    slo.clear_holds()
    assert slo.peek_resume() is b
    slo.pop_record(b)
    assert slo.peek_resume() is c
    assert slo.swaps_in == 1
    assert slo.backlog_size() == 2


@PKGS
def test_swap_cap_defaults_to_slot_count(pkg):
    slo = pkg.sched.SLOScheduler(pkg.sched.SLOConfig(), 2)
    assert slo.can_swap()
    slo.record_swap(_rec(pkg, 0, 0))
    slo.record_swap(_rec(pkg, 1, 0))
    assert not slo.can_swap()
    assert pkg.sched.SLOScheduler(pkg.sched.SLOConfig(max_swapped=5),
                                  2).max_swapped == 5


@PKGS
def test_shed_protects_high_class(pkg):
    slo = pkg.sched.SLOScheduler(pkg.sched.SLOConfig(high_class=1), 4)
    lo, hi = _rec(pkg, 0, 0), _rec(pkg, 1, 2)
    slo.record_swap(lo)
    slo.record_swap(hi)
    assert slo.pick_shed() is lo
    with pytest.raises(RuntimeError):
        slo.shed_record(hi)
    with pytest.raises(RuntimeError):
        slo.shed_uid(9, 1)
    slo.shed_record(lo)
    assert slo.pick_shed() is None
    assert slo.shed_uids == {0}
    assert slo.shed_high == 0


@PKGS
def test_shed_lifo_within_class(pkg):
    slo = pkg.sched.SLOScheduler(pkg.sched.SLOConfig(), 4)
    first, second = _rec(pkg, 0, 0), _rec(pkg, 1, 0)
    slo.record_swap(first)
    slo.record_swap(second)
    assert slo.pick_shed() is second


@PKGS
def test_stats_keys_complete(pkg):
    st = pkg.sched.SLOScheduler(pkg.sched.SLOConfig(), 2).stats()
    assert tuple(st) == SCHED_KEYS
    assert all(v == 0.0 for v in st.values())


class _Reg:
    """A duck-typed registry recording what ``publish`` writes."""

    def __init__(self):
        self.seen = {}

    def counter(self, name, help=""):
        return types.SimpleNamespace(
            add=lambda v: self.seen.__setitem__(name, ("counter", float(v))))

    def gauge(self, name, help=""):
        return types.SimpleNamespace(
            set=lambda v: self.seen.__setitem__(name, ("gauge", float(v))))


def _drive(pkg, seed, steps=60):
    """A seeded sequence of scheduler operations; returns every decision
    and the stats after each step."""
    rng = np.random.default_rng(seed)
    slo = pkg.sched.SLOScheduler(pkg.sched.SLOConfig(
        high_class=int(rng.integers(1, 3)),
        max_swapped=int(rng.integers(0, 4))), 3)
    trace, uid = [], 0
    for _ in range(steps):
        op = int(rng.integers(7))
        if op == 0 and slo.can_swap():
            rec = _rec(pkg, uid, int(rng.integers(0, 3)),
                       n_blocks=int(rng.integers(0, 5)))
            uid += 1
            slo.record_swap(rec)
            slo.swap_bytes += 10 * rec.n_blocks_swapped
            out = ("swap", rec.uid, rec.seq)
        elif op == 1:
            cands = [(int(rng.integers(0, 3)), int(rng.integers(0, 9)), j)
                     for j in range(int(rng.integers(0, 4)))]
            out = ("victim", slo.pick_victim(cands, int(rng.integers(0, 4))))
        elif op == 2:
            rec = slo.peek_resume()
            out = ("peek", None if rec is None else rec.uid)
            if rec is not None and rng.random() < 0.5:
                slo.pop_record(rec)
                slo.readopted_blocks += int(rng.integers(0, 3))
                slo.reuploaded_blocks += int(rng.integers(0, 3))
        elif op == 3 and slo.backlog_size():
            i = int(rng.integers(slo.backlog_size()))
            slo._backlog[i].hold = True
            out = ("hold", slo._backlog[i].uid)
        elif op == 4:
            slo.clear_holds()
            out = ("clear",)
        elif op == 5:
            rec = slo.pick_shed()
            out = ("shed", None if rec is None else rec.uid)
            if rec is not None:
                slo.shed_record(rec)
        else:
            p = int(rng.integers(0, 3))
            try:
                slo.shed_uid(1000 + uid, p)
                out = ("shed_uid", p)
            except RuntimeError:
                out = ("refused", p)
            uid += 1
        slo.deferrals += int(rng.integers(0, 2))
        trace.append((out, slo.stats(), sorted(slo.shed_uids)))
    reg = _Reg()
    slo.publish(reg)
    return trace, reg.seen


@pytest.mark.parametrize("seed", range(6))
def test_port_decisions_equal_reference(seed):
    """The same seeded operations give the same decisions, stats and
    published metrics in both schedulers."""
    got, pub = _drive(PORT, seed)
    want, pub_ref = _drive(REF, seed)
    assert got == want
    assert pub == pub_ref
    assert set(pub) == set(SCHED_KEYS)


# ---------------------------------------------------------------------------
# the pool's resume half and priority planning, against the reference
# ---------------------------------------------------------------------------


def _demand_pool(pkg, **kw):
    return pkg.pool.BlockPool(4, 16, pkg.pool.PagedKVConfig(
        block_size=4, pool_blocks=16), **kw)


def _release_case(pkg, case):
    """The reference's TestResumeDemand set-ups; returns the observable
    outcome: demands, readopt results and the pool's state."""
    pool = _demand_pool(pkg, **({"n_shards": 2} if case == "cross_shard"
                                else {}))
    for bi in range(4):
        pool.alloc(0, bi)
    keep = {"fresh_only": (0, 1), "recycled": (1, 3),
            "full_readopt": (0, 1, 2, 3),
            "cross_shard": (0, 1, 2, 3)}[case]
    for bi in keep:
        pool.retain(int(pool.table[0, bi]))
    held = pool.release_slot(0)
    if case == "recycled":
        for bi in range(4):
            pool.alloc(1, bi)
    out = {"held": sorted(held.items()),
           "demand": pool.resume_demand(0, held)}
    if case == "cross_shard":
        out["demand_other_shard"] = pool.resume_demand(2, held)
    before = (pool.allocated(), pool.table.tolist())
    assert pool.resume_demand(0, held) == out["demand"]     # idempotent
    assert (pool.allocated(), pool.table.tolist()) == before  # read-only
    out["readopted"] = [pool.readopt(0, bi, gid, gen)
                        for bi, (gid, gen) in sorted(held.items())]
    out["pool"] = (pool.table.tolist(), pool.ref.tolist(), pool.gen.tolist())
    return out


@pytest.mark.parametrize("case", ["fresh_only", "recycled", "full_readopt",
                                  "cross_shard"])
def test_resume_demand_equals_reference(case):
    got, want = _release_case(PORT, case), _release_case(REF, case)
    assert got == want
    # demand counts exactly the blocks readopt refuses
    assert got["demand"] == got["readopted"].count(False)
    expect = {"fresh_only": 2, "full_readopt": 0, "cross_shard": 0}
    if case in expect:
        assert got["demand"] == expect[case]
    if case == "cross_shard":
        assert got["demand_other_shard"] == 4


def test_plan_batches_orders_classes_as_reference():
    reqs = [(i, 10 + i, 4, i % 3) for i in range(9)]
    plan = rc_t.plan_batches([rc_t.Request(*r) for r in reqs], batch_size=2,
                             n_clusters=2, seed=0)
    want = rc_ref.plan_batches([rc_ref.Request(*r) for r in reqs],
                               batch_size=2, n_clusters=2, seed=0)
    assert plan.batches == want.batches
    assert plan.waste == pytest.approx(want.waste, rel=1e-6)
    prio = {r[0]: r[3] for r in reqs}
    for b in plan.batches:
        assert len({prio[u] for u in b}) == 1
    prios = [prio[b[0]] for b in plan.batches]
    assert prios == sorted(prios, reverse=True)


def test_single_class_plan_unchanged():
    reqs = [(i, 10 + 3 * i, 4) for i in range(6)]
    base = rc_t.plan_batches([rc_t.Request(*r) for r in reqs], batch_size=2,
                             n_clusters=2, seed=0)
    tagged = rc_t.plan_batches([rc_t.Request(*r, priority=5) for r in reqs],
                               batch_size=2, n_clusters=2, seed=0)
    assert base.batches == tagged.batches


# ---------------------------------------------------------------------------
# BlockPool + SLOScheduler state machine (port)
# ---------------------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 2), st.sampled_from([4, 8]),
       st.lists(st.tuples(st.integers(0, 3), st.integers(0, 4),
                          st.sampled_from(["admit", "decode", "preempt",
                                           "resume", "shed_active",
                                           "shed_parked"])),
                min_size=1, max_size=60),
       st.integers(0, 10_000))
def test_preempt_swap_resume_shed_conserve_pool(shards, bsz, ops, seed):
    """Whatever order the brownout ladder fires in, the port's pool
    conserves blocks: active slots map every allocated block, parked
    requests hold none, a resume re-adopts a block only if its (gid,
    generation) survived, and the protected class is never shed."""
    pool_m = kv_pool_t
    R = 16
    n_slots = 3 * shards
    pool = pool_m.BlockPool(n_slots, R, pool_m.PagedKVConfig(block_size=bsz),
                            n_shards=shards, slots_per_shard=3)
    slo = sched_t.SLOScheduler(sched_t.SLOConfig(), n_slots)
    occupant = {}
    t_of = np.zeros(n_slots, np.int64)
    next_uid = 0
    n_shed_parked = 0

    def mapped(slot):
        return int((pool.table[slot] >= 0).sum())

    def conserve():
        pool.check_invariants()
        assert pool.allocated() == sum(mapped(s) for s in occupant)
        for s in range(n_slots):
            if s not in occupant:
                assert mapped(s) == 0, s

    for slot_raw, arg, op in ops:
        slot = (slot_raw * shards) % n_slots
        if op == "admit" and slot not in occupant:
            prio = int(arg % 2)
            try:
                for b in pool_m.write_blocks(0, 1 + arg, R, bsz):
                    pool.alloc(slot, b)
            except pool_m.PoolExhausted:
                pool.free_slot(slot)
            else:
                occupant[slot] = (next_uid, prio)
                t_of[slot] = 1 + arg
                next_uid += 1
        elif op == "decode" and slot in occupant:
            try:
                for b in pool_m.write_blocks(int(t_of[slot]), 1, R, bsz):
                    pool.alloc(slot, b)
            except pool_m.PoolExhausted:
                pass
            else:
                t_of[slot] += 1
        elif op == "preempt" and occupant:
            cands = [(p, mapped(s), s) for s, (_, p) in occupant.items()]
            v = slo.pick_victim(cands, max(c[0] for c in cands) + 1)
            uid, prio = occupant.pop(v)
            held = pool.release_slot(v)
            slo.record_swap(sched_t.SwapRecord(
                uid=uid, priority=prio, pos=int(t_of[v]), cur=0, fed=0,
                since_tok=0, cov=0, max_new_tokens=4, deadline_ms=0.0,
                held=held, snap=None, tails=None, epoch=0, seq=0,
                n_blocks_swapped=len(held)))
        elif op == "resume" and slo.backlog_size() > 0:
            free = [s for s in range(n_slots) if s not in occupant]
            rec = slo.peek_resume()
            if free and rec is not None:
                slot = free[arg % len(free)]
                ok = True
                for bi, (gid, gen) in rec.held.items():
                    if not pool.readopt(slot, bi, gid, gen):
                        try:
                            pool.alloc(slot, bi)
                        except pool_m.PoolExhausted:
                            ok = False
                            break
                if not ok:
                    pool.free_slot(slot)
                else:
                    assert all(pool.table[slot, bi] >= 0 for bi in rec.held)
                    occupant[slot] = (rec.uid, rec.priority)
                    t_of[slot] = rec.pos
                    slo.pop_record(rec)
        elif op == "shed_active" and occupant:
            lows = [(p, s) for s, (_, p) in occupant.items()
                    if not slo.is_high(p)]
            if lows:
                _, v = min(lows)
                uid, prio = occupant.pop(v)
                slo.shed_uid(uid, prio)
                pool.free_slot(v)
        elif op == "shed_parked":
            rec = slo.pick_shed()
            if rec is not None:
                slo.shed_record(rec)
                n_shed_parked += 1
        conserve()

    assert slo.shed_high == 0
    assert slo.shed_uids <= set(range(next_uid))
    parked = {r.uid for r in slo._backlog}
    assert slo.shed_uids.isdisjoint({u for u, _ in occupant.values()}
                                    | parked)
    assert slo.swaps_out == (slo.swaps_in + slo.backlog_size()
                             + n_shed_parked)
    for s in list(occupant):
        pool.free_slot(s)
    pool.check_invariants()
    assert pool.allocated() == 0
    assert (pool.table == -1).all()


def test_readopt_rejects_recycled_block():
    """A released block whose generation moved must not re-adopt; one a
    co-owner kept live (ref never 0) must."""
    pool = kv_pool_t.BlockPool(2, 16, kv_pool_t.PagedKVConfig(block_size=4))
    pool.alloc(0, 0)
    (gid, gen), = pool.release_slot(0).values()
    assert not pool.readopt(0, 0, gid, gen)
    assert pool.table[0, 0] == -1
    g2 = pool.alloc(0, 0)
    pool.retain(g2)
    (gid2, gen2), = pool.release_slot(0).values()
    assert pool.ref[gid2] == 1
    assert pool.readopt(0, 0, gid2, gen2)
    assert pool.table[0, 0] == gid2 and pool.ref[gid2] == 2
    pool.free_block(0, 0)
    pool.release(gid2)
    pool.check_invariants()
    assert pool.allocated() == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swap_round_trip(dtype):
    """``Server._swap_out`` / ``_swap_in`` carry a slot's state and tail
    blocks to the host and back into another slot's fresh blocks bit for
    bit, leave the re-adopted (shared) block and every other block as they
    were (tests/_torch_swap.py)."""
    assert swap_round_trip("cpu", tiny(dtype))[:2] == (2, 1)


# ---------------------------------------------------------------------------
# engine: TestEnginePreemption's scenarios against the reference Server
# ---------------------------------------------------------------------------


def _mixed_stream(n=8, n_high=3, seed=3):
    """tests/test_scheduler.py's FIFO stream with a high-priority tail:
    best-effort requests arrive first and hold every slot."""
    rng = np.random.default_rng(seed)
    reqs, prompts = [], {}
    for i in range(n):
        plen = int(rng.integers(6, 30))
        prompts[i] = rng.integers(0, 64, size=(plen,)).astype(np.int32)
        reqs.append((i, plen, int(rng.integers(6, 14)),
                     1 if i >= n - n_high else 0))
    return reqs, prompts


def _deadline_stream():
    """test_deadline_shed_only_best_effort's stream: the best-effort tail
    carries a deadline of 1e-6 ms, so any failed admission sheds it."""
    rng = np.random.default_rng(11)
    reqs, prompts = [], {}
    for i in range(8):
        plen = int(rng.integers(12, 30))
        prompts[i] = rng.integers(0, 64, size=(plen,)).astype(np.int32)
        reqs.append((i, plen, 8, 1 if i < 2 else 0,
                     0.0 if i < 2 else 1e-6))
    return reqs, prompts


def _kw(chunk, pool_blocks, batch=2, prio_adm=False, **extra):
    return dict(batch_size=batch, max_seq=96, kv_compress=CCFG,
                prefill_chunk=chunk,
                paged=kv_pool_ref.PagedKVConfig(block_size=4,
                                                pool_blocks=pool_blocks),
                use_clustered_batching=False,
                scheduler=sched_ref.SLOConfig(priority_admission=prio_adm),
                **extra)


# name -> (stream, reference ServerConfig keywords)
SCENARIOS = {
    "chunked": (_mixed_stream, _kw(8, 10)),
    "blocking": (_mixed_stream, _kw(0, 10)),
    "overload": (lambda: _mixed_stream(n=10, n_high=3, seed=5),
                 _kw(8, 9, batch=4)),
    "priority_admission": (_mixed_stream, _kw(8, 10, prio_adm=True)),
    "deadline": (_deadline_stream, _kw(8, 8)),
    # prefix sharing under preemption: swapped-out slots hold blocks the
    # prefix cache pins, so resumes re-adopt them (the reference's
    # mode="drop" scatter, which the port replaces by host selection)
    "prefix_shared": (lambda: _template_stream(), _kw(
        8, 14, prefix_share=PrefixShareConfig())),
}


def _template_stream(n=6, seed=5):
    rng = np.random.default_rng(seed)
    template = rng.integers(0, 64, size=(24,)).astype(np.int32)
    reqs, prompts = [], {}
    for i in range(n):
        sfx = rng.integers(0, 64, size=(int(rng.integers(3, 9)),))
        prompts[i] = np.concatenate([template, sfx]).astype(np.int32)
        reqs.append((i, len(prompts[i]), int(rng.integers(6, 12)),
                     1 if i >= n - 2 else 0))
    return reqs, prompts


def port_kw(kw):
    """A reference ServerConfig's keywords with the port's types."""
    out = dict(kw)
    out["kv_compress"] = kv_t.KVCompressConfig(
        **dataclasses.asdict(kw["kv_compress"]))
    out["paged"] = kv_pool_t.PagedKVConfig(**dataclasses.asdict(kw["paged"]))
    if kw.get("scheduler") is not None:
        out["scheduler"] = sched_t.SLOConfig(
            **dataclasses.asdict(kw["scheduler"]))
    if kw.get("prefix_share") is not None:
        out["prefix_share"] = pc_t.PrefixShareConfig(
            **dataclasses.asdict(kw["prefix_share"]))
    return out


class _Runs:
    """Each scenario served once by the reference and once by the port,
    and once by the port with a big pool and no scheduler (the
    uninterrupted run); a serve is (outs by uid, last_stats, TTFT ms by
    uid), an out (tokens, shed)."""

    def __init__(self):
        self.params = ref_init_params(TINY)
        self.pt = bridge.params_from_numpy(
            jax.tree.map(np.asarray, self.params), TINY_T, "cpu")
        self._memo = {}

    def get(self, name):
        if name not in self._memo:
            self._memo[name] = self._run(name)
        return self._memo[name]

    @staticmethod
    def _serve(srv, reqs):
        outs = srv.serve(*reqs)
        return ({o.uid: (o.tokens, o.shed) for o in outs},
                dict(srv.last_stats), {o.uid: o.prefill_ms for o in outs})

    def _run(self, name):
        stream, kw = SCENARIOS[name]
        reqs, prompts = stream()
        ref = self._serve(Server(TINY, ServerConfig(**kw), self.params),
                          ([rc_ref.Request(*r) for r in reqs], prompts))
        port_reqs = ([rc_t.Request(*r) for r in reqs], prompts)
        port = self._serve(ServerT(TINY_T, ServerConfigT(**port_kw(kw)),
                                   self.pt, device="cpu"), port_reqs)
        big = dict(kw, scheduler=None,
                   paged=kv_pool_ref.PagedKVConfig(block_size=4,
                                                   pool_blocks=48))
        whole = self._serve(ServerT(TINY_T, ServerConfigT(**port_kw(big)),
                                    self.pt, device="cpu"), port_reqs)
        return {"ref": ref, "port": port, "whole": whole, "reqs": reqs}


@pytest.fixture(scope="module")
def runs():
    return _Runs()


ENGINE = list(SCENARIOS)


@pytest.mark.parametrize("name", ENGINE)
def test_tokens_and_shed_flags_equal_reference(runs, name):
    r = runs.get(name)
    assert r["port"][0] == r["ref"][0]


@pytest.mark.parametrize("name", ENGINE)
def test_sched_stats_equal_reference(runs, name):
    r = runs.get(name)
    st, st_ref = r["port"][1], r["ref"][1]
    # the port-only blocking admission counts stay out of last_stats
    # (Server.last_admission)
    assert set(st) == set(st_ref)
    for key in SCHED_KEYS + ("decode_steps", "gen_tokens", "prefill_chunks",
                             "kv_absorbs", "kv_compactions", "pool_allocs",
                             "pool_frees", "pool_blocks_peak",
                             "pool_blocks_end", "pool_retains", "pool_cow"):
        if key in st_ref:
            assert st[key] == st_ref[key], key


@pytest.mark.parametrize("name", ENGINE)
def test_preemption_is_schedule_invisible(runs, name):
    """The reference's invariants, on the port: the protected class
    completes in full and unshed, only best-effort work sheds, and every
    non-shed request's tokens equal the uninterrupted run's."""
    r = runs.get(name)
    outs, st, _ = r["port"]
    whole = r["whole"][0]
    assert st["sched_shed_high"] == 0.0
    assert st["sched_backlog_end"] == 0.0 and st["pool_blocks_end"] == 0.0
    assert sorted(outs) == sorted(q[0] for q in r["reqs"])
    for q in r["reqs"]:
        uid, _, gen, prio = q[:4]
        toks, shed = outs[uid]
        if prio >= 1:
            assert not shed and len(toks) == gen, uid
        if not shed:
            assert toks == whole[uid][0], uid
        else:
            assert toks == whole[uid][0][:len(toks)], uid


@pytest.mark.parametrize("name", ["chunked", "blocking", "prefix_shared"])
def test_preempts_and_resumes(runs, name):
    st = runs.get(name)["port"][1]
    assert st["sched_preemptions"] >= 1.0 and st["sched_swaps_in"] >= 1.0
    assert st["sched_reuploaded_blocks"] > 0
    if name == "prefix_shared":
        # blocks pinned by the prefix cache survived the swap-out
        assert st["sched_readopted_blocks"] > 0


def test_priority_admission_orders_protected_first(runs):
    """Priority admission: every protected TTFT beats every best-effort
    one, as in the reference."""
    r = runs.get("priority_admission")
    outs, _, ttft = r["port"]
    prio = {q[0]: q[3] for q in r["reqs"]}
    hi = [ttft[u] for u in outs if prio[u] >= 1]
    lo = [ttft[u] for u in outs if prio[u] == 0 and not outs[u][1]]
    assert hi and lo and max(hi) < min(lo)


def test_overload_sheds_only_best_effort(runs):
    r = runs.get("overload")
    outs, st, _ = r["port"]
    prio = {q[0]: q[3] for q in r["reqs"]}
    shed = [u for u, (_, s) in outs.items() if s]
    assert all(prio[u] == 0 for u in shed)
    assert st["sched_sheds"] == float(len(shed))


def test_deadline_sheds_only_best_effort(runs):
    r = runs.get("deadline")
    outs, st, _ = r["port"]
    prio = {q[0]: q[3] for q in r["reqs"]}
    assert st["sched_sheds"] == float(sum(s for _, s in outs.values()))
    assert all(not outs[u][1] for u in prio if prio[u] >= 1)


@pytest.mark.parametrize("case", ["dense", "no_kv_compress", "window",
                                  "static"])
def test_scheduler_misuse_raises_reference_error(runs, case):
    """Without the paged clustered continuous engine over 'G' layers the
    port refuses ``scheduler=`` with the reference's ValueError."""
    cfg_kw = dict(_TINY_KW)
    kw = dict(batch_size=2, max_seq=64, scheduler=sched_ref.SLOConfig())
    if case == "no_kv_compress":
        kw["paged"] = kv_pool_ref.PagedKVConfig(block_size=4)
    elif case == "dense":
        kw["kv_compress"] = CCFG
    elif case == "window":
        kw.update(kv_compress=CCFG,
                  paged=kv_pool_ref.PagedKVConfig(block_size=4))
        cfg_kw.update(layer_pattern="GL", sliding_window=16)
    else:
        kw.update(kv_compress=CCFG, engine="static",
                  paged=kv_pool_ref.PagedKVConfig(block_size=4))
    params = runs.params if case != "window" else tfm.init_params(
        jax.random.PRNGKey(0), ModelConfig(**cfg_kw))
    with pytest.raises(ValueError) as want:
        Server(ModelConfig(**cfg_kw), ServerConfig(**kw), params)
    pkw = dict(kw, scheduler=sched_t.SLOConfig())
    if "kv_compress" in kw:
        pkw["kv_compress"] = kv_t.KVCompressConfig(
            **dataclasses.asdict(CCFG))
    if "paged" in kw:
        pkw["paged"] = kv_pool_t.PagedKVConfig(block_size=4)
    pt = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                  ModelConfigT(**cfg_kw), "cpu")
    with pytest.raises(ValueError) as got:
        ServerT(ModelConfigT(**cfg_kw), ServerConfigT(**pkw), pt,
                device="cpu")
    assert str(got.value) == str(want.value)


def test_no_scheduler_stats_absent(runs):
    r = runs.get("chunked")
    assert "sched_preemptions" not in r["whole"][1]
    assert not any(s for _, s in r["whole"][0].values())
