#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the hand-written kernels from ``src/repro_torch/csrc``
   with nvcc (sm_90a), all at once;
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card at the serving path's shapes (clustered_decode: B=4, L=64, Hq=32,
   Hkv=8, Dh=128, C=64, R=256 in bf16, f32 and f32 + softcap 50;
   paged_clustered_decode: the same data as 130 packed rows in a 256-row
   bucket over a pool of 16-position blocks behind a shuffled block
   table, in the same three cases, bit-equal to clustered_decode on every
   real row, and its window floor ``wlo`` exact;
   distance_argmin: N=2^20, D=16, K=64, L1 and L2);
4. model agreement: the reduced qwen3 in f32 decodes (mixed and plain
   steps, clustered cache) with the same logits on the card as on the CPU;
5. serve: qwen3-4b at full width (random weights, seed 0, bf16) answers 8
   requests through the continuous engine with chunked admission and a
   clustered KV cache; the clustered_decode launch count must equal
   layers x engine steps;
5b. paged serve: the same requests through the paged engine
   (``PagedKVConfig(block_size=16)``, packed ragged launches); the
   paged_clustered_decode launch count must equal layers x engine steps,
   and the pool must recycle blocks and drain to zero;
6. k-medians: ``clustering.fit`` at its default (distance_argmin kernel),
   L1 medians, k=64 on 2^20 x 16 points;
7. times: CUDA-event medians of 50 launches per kernel beside its plain
   version, a library yardstick and the card's bound.

It imports ``repro_torch`` only.  The second-to-last line is the kernels
JSON, ``{"kernels": [{"name": ..., ...}, ...]}`` with one object per
kernel (``chiprun_out/chip_smoke.json`` keys the same objects by name),
and the last line ``{"ok": true, "device": {...}}``; the full record goes
to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores, dense bf16 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12

# serving path shapes of qwen3-4b under the smoke's ServerConfig
B, L, HQ, HKV, DH, C, R = 4, 64, 32, 8, 128, 64, 256
T_SLOTS = [100, 1000, 300, 50]       # unwrapped, wrapped, wrapped, unwrapped
CL_SLOTS = [64, 64, 1, 1]            # two chunks in flight, two decode rows
COV_SLOTS = [0, 900, 60, 10]         # cov >= t + chunk_len - R everywhere
BS = 16                              # paged: positions per pool block
N_BUCKET = 256                       # paged: row bucket of the 130 rows
N_PTS, D_PTS, K_PTS = 1 << 20, 16, 64


def say(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, n=50, warm=5):
    """Median CUDA-event time of ``n`` calls after ``warm`` warm-ups."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def decode_inputs(torch, dev, dtype):
    g = torch.Generator(device="cpu").manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    counts = torch.randint(0, 5, (B, C, HKV), generator=g).float()
    return dict(
        q=rnd(B, L, HQ, DH).to(dev, dtype),
        k_cents=rnd(B, C, HKV, DH).to(dev, dtype),
        v_cents=rnd(B, C, HKV, DH).to(dev, dtype),
        counts=counts.to(dev),                  # ~20% empty clusters
        k_tail=rnd(B, R, HKV, DH).to(dev, dtype),
        v_tail=rnd(B, R, HKV, DH).to(dev, dtype),
        t=torch.tensor(T_SLOTS, dtype=torch.int32, device=dev),
        cov=torch.tensor(COV_SLOTS, dtype=torch.int32, device=dev),
        chunk_len=torch.tensor(CL_SLOTS, dtype=torch.int32, device=dev))


def check_clustered_decode(torch, cd, dev):
    """bf16 (vs plain in f32 cast to bf16, 2 bf16 ulps), f32 and f32 with
    softcap 50 (1e-5); valid rows only."""
    max_err = 0.0
    cases = [("bf16", torch.bfloat16, None, 1.6e-2),
             ("f32", torch.float32, None, 1e-5),
             ("f32_softcap50", torch.float32, 50.0, 1e-5)]
    for name, dtype, cap, tol in cases:
        x = decode_inputs(torch, dev, dtype)
        got = cd.clustered_decode_cuda(**x, scale=DH ** -0.5, softcap=cap)
        f32 = {k: (v.float() if v.is_floating_point() else v)
               for k, v in x.items()}
        want = cd.clustered_decode_plain(**f32, scale=DH ** -0.5,
                                         softcap=cap).to(dtype)
        # the one-token decode form on the same cache
        x1 = dict(x, q=x["q"][:, 0].contiguous(), chunk_len=None)
        got1 = cd.clustered_decode_cuda(**x1, scale=DH ** -0.5, softcap=cap)
        want1 = cd.clustered_decode_plain(
            **dict(f32, q=f32["q"][:, 0], chunk_len=None), scale=DH ** -0.5,
            softcap=cap).to(dtype)
        torch.cuda.synchronize()
        for b in range(B):
            n = CL_SLOTS[b]
            torch.testing.assert_close(got[b, :n].float(),
                                       want[b, :n].float(), rtol=tol,
                                       atol=tol)
            max_err = max(max_err, (got[b, :n].float()
                                    - want[b, :n].float()).abs().max().item())
        torch.testing.assert_close(got1.float(), want1.float(), rtol=tol,
                                   atol=tol)
        max_err = max(max_err, (got1.float() - want1.float()).abs().max()
                      .item())
        say(f"clustered_decode {name}: kernel == plain within {tol} "
            f"(max abs err so far {max_err:.3e})")
    return max_err


def paged_inputs(torch, x, cl, bucket, seed=1):
    """The dense kernel's inputs ``x`` as packed paged rows: each slot's
    live ring blocks (positions in [cov, t + cl)) scattered through a
    shuffled block table into a pool of BS-position blocks; unmapped
    entries point at the base block 0, which holds non-zero garbage, as
    ``BlockPool.table_for_read`` maps them; one row per (slot, chunk row
    i < cl[slot]), padded to ``bucket`` rows on slot 0 with qpos1 0.
    Returns (kernel args, rows, mapped block count)."""
    from repro_torch.runtime.kv_pool import live_blocks

    dev = x["q"].device
    nt = R // BS
    g = torch.Generator(device="cpu").manual_seed(seed)
    mapped = [(b, bi) for b in range(B)
              for bi in live_blocks(T_SLOTS[b] + cl[b], COV_SLOTS[b], R, BS)]
    nb = 1 + len(mapped) + 8                    # base + mapped + spares
    ids = (1 + torch.randperm(nb - 1, generator=g)[:len(mapped)]).tolist()
    table = torch.zeros(B, nt, dtype=torch.int32)
    pools = {}
    for key in ("k_tail", "v_tail"):
        pool = torch.randn(nb, BS, HKV, DH, generator=g).to(dev, x[key].dtype)
        blocks = x[key].reshape(B, nt, BS, HKV, DH)
        for (b, bi), gid in zip(mapped, ids):
            pool[gid] = blocks[b, bi]
            table[b, bi] = gid
        pools[key] = pool
    rows = [(b, i) for b in range(B) for i in range(cl[b])]
    vec = torch.zeros(4, bucket, dtype=torch.int32)   # slot, qpos1, tw, cov
    for k, (b, i) in enumerate(rows):
        vec[:, k] = torch.tensor([b, T_SLOTS[b] + i + 1, T_SLOTS[b] + cl[b],
                                  COV_SLOTS[b]])
    vec = vec.to(dev)
    q = torch.zeros(bucket, HQ, DH, dtype=x["q"].dtype, device=dev)
    q[:len(rows)] = x["q"][[b for b, _ in rows], [i for _, i in rows]]
    args = dict(q=q, k_cents=x["k_cents"], v_cents=x["v_cents"],
                counts=x["counts"], k_pool=pools["k_tail"],
                v_pool=pools["v_tail"], row_slot=vec[0].contiguous(),
                row_bt=table.to(dev)[vec[0].long()].contiguous(),
                qpos1=vec[1].contiguous(), tw=vec[2].contiguous(),
                cov=vec[3].contiguous())
    return args, rows, len(mapped)


def bits(torch, t):
    """A float tensor's bit patterns, for exact comparison (-0 != +0)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_paged_decode(torch, cd, pcd, dev):
    """paged_clustered_decode on B1's phase-3 data: against its plain
    version (same cases and tolerances as B1), bit for bit against B1 on
    every real row, and (f32) the window floor: (cov, wlo) equals
    (max(cov, wlo), 0) exactly and masks more than cov alone."""
    max_err = 0.0
    cases = [("bf16", torch.bfloat16, None, 1.6e-2),
             ("f32", torch.float32, None, 1e-5),
             ("f32_softcap50", torch.float32, 50.0, 1e-5)]
    for name, dtype, cap, tol in cases:
        x = decode_inputs(torch, dev, dtype)
        args, rows, n_mapped = paged_inputs(torch, x, CL_SLOTS, N_BUCKET)
        kw = dict(scale=DH ** -0.5, softcap=cap)
        got = pcd.paged_clustered_decode_cuda(**args, **kw)
        f32 = {k: (v.float() if v.is_floating_point() else v)
               for k, v in args.items()}
        want = pcd.paged_clustered_decode_plain(**f32, **kw).to(dtype)
        dense = cd.clustered_decode_cuda(**x, **kw)
        torch.cuda.synchronize()
        n = len(rows)
        torch.testing.assert_close(got[:n].float(), want[:n].float(),
                                   rtol=tol, atol=tol)
        if not torch.isfinite(got).all():
            raise AssertionError(f"paged {name}: non-finite output")
        max_err = max(max_err, (got[:n].float() - want[:n].float()).abs()
                      .max().item())
        ref = dense[[b for b, _ in rows], [i for _, i in rows]]
        differ = (bits(torch, got[:n]) != bits(torch, ref)).any(-1).any(-1)
        if differ.any():
            raise AssertionError(
                f"paged {name}: {int(differ.sum())} of {n} real rows differ "
                "from clustered_decode bit for bit")
        say(f"paged_clustered_decode {name}: kernel == plain within {tol}; "
            f"all {n} real rows bit-equal to clustered_decode "
            f"({n_mapped} mapped blocks of {BS}, {N_BUCKET}-row bucket; "
            f"max abs err so far {max_err:.3e})")
        if name != "f32":
            continue
        cov = args["cov"]
        wlo = torch.zeros_like(cov)
        wlo[0:n:3] = cov[0:n:3] + 37              # above cov
        wlo[1:n:3] = torch.clamp(cov[1:n:3] - 5, min=0)   # below cov
        floor = pcd.paged_clustered_decode_cuda(**args, wlo=wlo, **kw)
        merged = pcd.paged_clustered_decode_cuda(
            **dict(args, cov=torch.maximum(cov, wlo)),
            wlo=torch.zeros_like(wlo), **kw)
        torch.cuda.synchronize()
        if not torch.equal(bits(torch, floor[:n]), bits(torch, merged[:n])):
            raise AssertionError("paged wlo: (cov, wlo) != (max(cov, wlo), "
                                 "0) bit for bit")
        moved = (floor[0:n:3] - got[0:n:3]).abs().amax((1, 2))
        if not (moved > 0).all():
            raise AssertionError("paged wlo: the window floor masked nothing")
        say("paged_clustered_decode f32 window floor: (cov, wlo) == "
            "(max(cov, wlo), 0) bit for bit on every real row")
    return max_err


def check_distance_argmin(torch, da, dev):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(N_PTS, D_PTS)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(K_PTS, D_PTS)).astype(np.float32))
    c[5] = c[2]                  # duplicated centroid: the first index wins
    x[0] = c[2]
    x, c = x.to(dev), c.to(dev)
    max_err = 0.0
    for metric in ("l1", "l2"):
        a, m = da.distance_argmin_cuda(x, c, metric=metric)
        a0, m0 = da.distance_argmin_plain(x, c, metric=metric)
        torch.cuda.synchronize()
        agree = (a == a0).float().mean().item()
        if agree < 0.9999:
            raise AssertionError(f"{metric}: assignments agree on {agree}")
        diff = torch.nonzero(a != a0)[:, 0]
        if len(diff):
            # a disagreement must be a near-tie of the two distances
            xd = x[diff]
            if metric == "l1":
                d_k = (xd - c[a[diff].long()]).abs().sum(1)
                d_p = (xd - c[a0[diff].long()]).abs().sum(1)
            else:
                d_k = ((xd - c[a[diff].long()]) ** 2).sum(1)
                d_p = ((xd - c[a0[diff].long()]) ** 2).sum(1)
            torch.testing.assert_close(d_k, d_p, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(m, m0, rtol=1e-5, atol=1e-5)
        if int(a[0]) != 2 or int((a == 5).sum()) != 0:
            raise AssertionError(f"{metric}: duplicated centroid did not "
                                 "resolve to the first index")
        max_err = max(max_err, (m - m0).abs().max().item())
        say(f"distance_argmin {metric}: assignments agree on "
            f"{agree * 100:.5f}% ({len(diff)} near-ties), mindist max abs "
            f"err {(m - m0).abs().max().item():.3e}")
    return max_err, x, c


# ---------------------------------------------------------------------------
# phase 4: the whole model on the card against the CPU, small and f32
# ---------------------------------------------------------------------------


def check_small_model(torch, dev):
    from repro_torch import configs
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(configs.get_reduced("qwen3-4b"),
                              dtype="float32")
    p_cpu = tfm.init_params(0, cfg, device="cpu")
    p_gpu = {"embed": {k: v.to(dev) for k, v in p_cpu["embed"].items()},
             "layers": [{k: {kk: vv.to(dev) for kk, vv in v.items()}
                         for k, v in lp.items()} for lp in p_cpu["layers"]],
             "final_norm": {k: v.to(dev)
                            for k, v in p_cpu["final_norm"].items()}}
    caches = [tfm.init_cache(cfg, 2, 64, kv_mode="clustered", kv_clusters=8,
                             kv_tail=16, device=d) for d in ("cpu", dev)]
    rng = np.random.default_rng(0)
    steps = [((0, 6), (0, 3)), ((6, 6), (3, 6))] + [None] * 4
    t = np.zeros(2, np.int32)
    worst = 0.0
    for step in steps:
        if step is None:
            tok = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
            tv, kw = t.copy(), {}
            t += 1
        else:
            tok = rng.integers(0, cfg.vocab, size=(2, 6)).astype(np.int32)
            tv = np.array([s[0] for s in step], np.int32)
            cl = np.array([s[1] for s in step], np.int32)
            kw = {"chunk_len": cl}
            t = tv + cl
        outs = []
        for params, cache, d in ((p_cpu, caches[0], "cpu"),
                                 (p_gpu, caches[1], dev)):
            kwd = {k: torch.from_numpy(v).to(d) for k, v in kw.items()}
            logits, _ = tfm.decode_step(params, cfg, cache,
                                        torch.from_numpy(tok).to(d),
                                        torch.from_numpy(tv).to(d), **kwd)
            outs.append(logits.float().cpu())
        torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-4)
        worst = max(worst, (outs[1] - outs[0]).abs().max().item())
    say(f"reduced qwen3 f32 decode: card == CPU logits (max abs err "
        f"{worst:.3e}) over 2 mixed + 4 decode steps")


# ---------------------------------------------------------------------------
# phase 5: serve qwen3-4b
# ---------------------------------------------------------------------------


def serve_workload(torch, dev, paged=None, params=None):
    """The smoke's serve: qwen3-4b at full width (random weights from seed
    0, bf16) behind a clustered-KV Server — paged when ``paged`` is a
    ``PagedKVConfig`` — and 8 requests.  ``params`` reuses weights made by
    an earlier call.  Returns ``(cfg, server, requests, prompts)``;
    benchmarks/profile_torch_serve.py profiles the same workload."""
    from repro_torch import configs
    from repro_torch.core.kv_compress import KVCompressConfig
    from repro_torch.core.request_cluster import Request
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = configs.get_config("qwen3-4b")           # all 36 layers
    if params is None:
        t0 = time.perf_counter()
        params = tfm.init_params(torch.Generator(device=dev).manual_seed(0),
                                 cfg, device=dev)
        torch.cuda.synchronize()
        say(f"qwen3-4b params ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
            f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
            f"{cfg.dtype}) initialised in {time.perf_counter() - t0:.1f} s")
    ccfg = KVCompressConfig(n_clusters=64, iters=4, bits=16, keep_recent=256,
                            refresh_every=32, prompt_clusters=32)
    scfg = ServerConfig(batch_size=4, max_seq=2048, prefill_chunk=64,
                        kv_compress=ccfg, paged=paged)
    srv = Server(cfg, scfg, params, device=dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(96, 1537, size=8)
    gens = rng.integers(40, 73, size=8)
    reqs = [Request(i, int(lens[i]), int(gens[i])) for i in range(8)]
    prompts = {i: rng.integers(0, cfg.vocab, size=int(lens[i]))
               .astype(np.int32) for i in range(8)}
    return cfg, srv, reqs, prompts


def serve_qwen3(torch, dev, smi, paged=None, params=None):
    """Serve the workload once, dense or paged, and hold it to its gates.
    Returns (record, params)."""
    from repro_torch.kernels import ops

    cfg, srv, reqs, prompts = serve_workload(torch, dev, paged, params)
    lens = np.array([r.prompt_len for r in reqs])
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = srv.serve(reqs, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    st = srv.last_stats
    mode = "paged" if paged is not None else "dense"
    for o in outs:
        want = reqs[o.uid].max_new_tokens
        if len(o.tokens) != want:
            raise AssertionError(f"{mode} uid {o.uid}: {len(o.tokens)} "
                                 f"tokens, want {want}")
        if not all(0 <= t < cfg.padded_vocab for t in o.tokens):
            raise AssertionError(f"{mode} uid {o.uid}: token out of range")
    if not (st["kv_absorbs"] > 0 and st["kv_compactions"] > 0):
        raise AssertionError(f"{mode}: absorbs {st['kv_absorbs']}, "
                             f"compactions {st['kv_compactions']}: the "
                             "clustered path did not run")
    steps = int(st["decode_steps"])
    kernel, other = (("paged_clustered_decode", "clustered_decode")
                     if paged is not None else
                     ("clustered_decode", "paged_clustered_decode"))
    if launches[kernel] != cfg.n_layers * steps or launches[other] != 0:
        raise AssertionError(
            f"{mode}: {kernel} launched {launches[kernel]} times, want "
            f"layers x steps = {cfg.n_layers} x {steps}; {other} "
            f"{launches[other]}, want 0")
    pool = ""
    if paged is not None:
        allocs, frees = int(st["pool_allocs"]), int(st["pool_frees"])
        peak, end = int(st["pool_blocks_peak"]), int(st["pool_blocks_end"])
        if not (frees == allocs > peak and end == 0):
            raise AssertionError(
                f"paged pool: allocs {allocs}, frees {frees}, peak {peak}, "
                f"end {end}: want frees == allocs > peak and end 0")
        pool = (f"; pool {int(st['pool_blocks_total'])} blocks of "
                f"{paged.block_size}, peak {peak}, {allocs} allocs = "
                f"{frees} frees, end {end}, launch_pad_frac "
                f"{st['launch_pad_frac']:.4f}")
    tokens = {o.uid: list(map(int, o.tokens)) for o in outs}
    digest = hashlib.sha256(json.dumps(tokens, sort_keys=True).encode())
    say(f"{mode} serve: 8 requests ({int(lens.sum())} prompt tokens, "
        f"{int(st['gen_tokens'])} generated) in {wall:.1f} s wall; "
        f"{steps} engine steps, {int(st['kv_absorbs'])} absorbs, "
        f"{int(st['kv_compactions'])} compactions; {kernel} launches "
        f"{launches[kernel]} = {cfg.n_layers} x {steps}{pool}; tokens "
        f"sha256 {digest.hexdigest()[:16]}")
    say(f"[{smi}] {mode}: tokens_per_s {st['tokens_per_s']:.1f}  "
        f"tokens_per_s_wall {st['tokens_per_s_wall']:.1f}  "
        f"ttft_p50_ms {st['ttft_p50_ms']:.1f}  ttft_p95_ms "
        f"{st['ttft_p95_ms']:.1f}  itl_p50_ms {st['itl_p50_ms']:.2f}  "
        f"itl_p95_ms {st['itl_p95_ms']:.2f}")
    return ({"n_layers": cfg.n_layers, "stats": st, "wall_s": wall,
             "launches": launches, "engine_steps": steps,
             "tokens": tokens}, srv.params)


def compare_tokens(dense, paged):
    """How many requests' tokens the paged serve shares with the dense
    serve, and where each other request first differs (not gated: the
    trunk GEMMs see other row counts, so cuBLAS may round differently)."""
    first = {}
    for uid, want in dense["tokens"].items():
        got = paged["tokens"][uid]
        diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        if diff:
            first[uid] = diff[0]
    say(f"paged vs dense tokens: {len(dense['tokens']) - len(first)} of "
        f"{len(dense['tokens'])} requests equal"
        + ("" if not first else "; first differing position by uid "
           + json.dumps(first)))
    return first


# ---------------------------------------------------------------------------
# phase 6: k-medians through the distance_argmin kernel
# ---------------------------------------------------------------------------


def kmedians(torch, dev):
    from repro_torch.core import clustering
    from repro_torch.kernels import ops

    rng = np.random.default_rng(1)
    centers = rng.normal(size=(K_PTS, D_PTS)) * 4.0
    lab = rng.integers(0, K_PTS, size=N_PTS)
    x = (centers[lab] + rng.normal(size=(N_PTS, D_PTS))).astype(np.float32)
    x = torch.from_numpy(x).to(dev)
    cfg = clustering.ClusterConfig(k=K_PTS, metric="l1", centroid="median",
                                   bits=32, max_iters=20, seed=0)
    init = clustering.init_kmeanspp(torch.Generator().manual_seed(0), x,
                                    K_PTS, "l1")
    first = clustering.fit(x, dataclasses.replace(cfg, max_iters=1), init)
    ops.reset_launches()
    t0 = time.perf_counter()
    res = clustering.fit(x, cfg, init)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_launch = ops.launch_counts()["distance_argmin"]
    inertia, inertia1 = float(res.inertia), float(first.inertia)
    if n_launch <= 0:
        raise AssertionError("fit did not launch distance_argmin")
    if not (np.isfinite(inertia) and inertia <= inertia1):
        raise AssertionError(f"inertia {inertia} vs first iteration "
                             f"{inertia1}")
    say(f"k-medians fit: {int(res.n_iters)} iterations in {secs:.2f} s, "
        f"{n_launch} distance_argmin launches, inertia {inertia:.6g} "
        f"(first iteration {inertia1:.6g})")
    return {"launches": n_launch, "iters": int(res.n_iters),
            "inertia": inertia, "inertia_first": inertia1, "seconds": secs}


# ---------------------------------------------------------------------------
# phase 7: times and bounds
# ---------------------------------------------------------------------------


def decode_flops(counts, cl):
    """Flops of the valid rows (chunk rows i < cl[b]) against the entries
    they can see, for q.k and for p.v alike, 2 flops per multiply-add."""
    counts = counts.cpu().numpy()                              # (B, C, Hkv)
    flops = 0
    g = HQ // HKV
    for b in range(B):
        tw = T_SLOTS[b] + cl[b]
        s = np.arange(R)
        pos = s if tw <= R else tw - R + np.mod(s - tw, R)
        for i in range(cl[b]):
            ring = int(((pos >= COV_SLOTS[b]) & (pos <= T_SLOTS[b] + i)).sum())
            cents = (counts[b] > 0).sum(0)                     # (Hkv,)
            flops += int(((cents + ring) * g).sum()) * DH * 2
    return flops


def decode_work(x):
    """Bytes each input read once and each output written once, and the
    flops of the valid rows against the entries they can see: ``(bytes,
    q.k flops, p.v flops)``."""
    nbytes = sum(v.numel() * v.element_size() for v in x.values())
    nbytes += x["q"].numel() * x["q"].element_size()          # output
    flops = decode_flops(x["counts"], CL_SLOTS)
    return nbytes, flops, flops


def paged_work(args, rows, n_mapped, cl):
    """The least bytes paged_clustered_decode must move for these rows:
    each real row's q and output once, each slot's centroids and counts
    once, each mapped pool block once, the row vectors and block-table
    rows once; and the same flops as the dense rows they equal."""
    el = args["q"].element_size()
    n = len(rows)
    nbytes = 2 * n * HQ * DH * el                          # q in, out
    nbytes += B * C * HKV * (2 * DH * el + 4)              # cents, counts
    nbytes += 2 * n_mapped * BS * HKV * DH * el            # k/v blocks
    nbytes += n * 4 * (5 + args["row_bt"].shape[1])        # int vectors
    flops = decode_flops(args["counts"], cl)
    return nbytes, flops, flops


def bound(nbytes, ops):
    """Least time in ms: bytes over the memory rate, or the operations,
    given as (flops, rate) pairs, each over its rate, whichever is longer."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = sum(f / rate for f, rate in ops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_yardstick(torch, x):
    """One scaled_dot_product_attention over [centroids ⊕ ring] with a
    float mask carrying log(count) and the masks (built outside the
    timed call)."""
    import torch.nn.functional as F

    g = HQ // HKV
    k = torch.cat([x["k_cents"], x["k_tail"]], 1).transpose(1, 2)
    v = torch.cat([x["v_cents"], x["v_tail"]], 1).transpose(1, 2)
    k = k.repeat_interleave(g, 1).contiguous()                 # (B, Hq, E, Dh)
    v = v.repeat_interleave(g, 1).contiguous()
    q = x["q"].transpose(1, 2).contiguous()                    # (B, Hq, L, Dh)
    dev = q.device
    cnt = x["counts"].transpose(1, 2).repeat_interleave(g, 1)  # (B, Hq, C)
    bias_c = torch.where(cnt > 0, torch.log(cnt.clamp_min(1e-9)),
                         torch.full_like(cnt, -1e30))[:, :, None, :]
    t = x["t"].long()[:, None]
    tw = t + x["chunk_len"].long()[:, None]
    s = torch.arange(R, device=dev)[None]
    pos = torch.where(tw <= R, s, tw - R + torch.remainder(s - tw, R))
    i = torch.arange(L, device=dev)[None, :, None]
    ok = ((pos[:, None, :] <= t[:, :, None] + i)
          & (pos[:, None, :] >= x["cov"].long()[:, None, None]))
    bias_t = torch.where(ok, 0.0, -1e30)[:, None].expand(B, HQ, L, R)
    mask = torch.cat([bias_c.expand(B, HQ, L, C), bias_t], -1).to(q.dtype)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=DH ** -0.5)


def paged_sdpa_yardstick(torch, args):
    """One scaled_dot_product_attention over each row's [centroids ⊕
    ring gathered through its block table] (gather and float mask built
    outside the timed call), every row of the bucket a batch entry."""
    import torch.nn.functional as F

    g = HQ // HKV
    n = args["q"].shape[0]
    rs = args["row_slot"].long()
    dev = args["q"].device

    def entries(cents, pool):
        ring = pool[args["row_bt"].long()].reshape(n, R, HKV, DH)
        kv = torch.cat([cents[rs], ring], 1).transpose(1, 2)   # (N, Hkv, E, Dh)
        return kv.repeat_interleave(g, 1).contiguous()

    k = entries(args["k_cents"], args["k_pool"])
    v = entries(args["v_cents"], args["v_pool"])
    q = args["q"][:, :, None].contiguous()                     # (N, Hq, 1, Dh)
    cnt = args["counts"][rs].transpose(1, 2).repeat_interleave(g, 1)
    bias_c = torch.where(cnt > 0, torch.log(cnt.clamp_min(1e-9)),
                         torch.full_like(cnt, -1e30))[:, :, None, :]
    tw = args["tw"].long()[:, None]
    s = torch.arange(R, device=dev)[None]
    pos = torch.where(tw <= R, s, tw - R + torch.remainder(s - tw, R))
    ok = ((pos < args["qpos1"].long()[:, None])
          & (pos >= args["cov"].long()[:, None]))
    bias_t = torch.where(ok, 0.0, -1e30)[:, None, None, :].expand(n, HQ, 1, R)
    mask = torch.cat([bias_c, bias_t], -1).to(q.dtype)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=DH ** -0.5)


def time_paged(torch, pcd, x, cl, bucket):
    """B2 at one shape: kernel, plain, SDPA yardstick and bound."""
    args, rows, n_mapped = paged_inputs(torch, x, cl, bucket)
    kw = dict(scale=DH ** -0.5)
    ms = time_ms(torch, lambda: pcd.paged_clustered_decode_cuda(**args,
                                                                **kw))
    plain = time_ms(torch, lambda: pcd.paged_clustered_decode_plain(**args,
                                                                    **kw))
    lib = time_ms(torch, paged_sdpa_yardstick(torch, args))
    nb, fl_qk, fl_pv = paged_work(args, rows, n_mapped, cl)
    b_ms, b_by = bound(nb, [(fl_qk, PEAK_BF16_FLOP_PER_S),
                            (fl_pv, PEAK_F32_FLOP_PER_S)])
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, bytes=nb, flops_qk=fl_qk, flops_pv=fl_pv,
                rows=len(rows), bucket=bucket, mapped_blocks=n_mapped)


def timings(torch, cd, pcd, da, dev, xa, ca):
    x = decode_inputs(torch, dev, torch.bfloat16)
    kw = dict(scale=DH ** -0.5)
    cd_ms = time_ms(torch, lambda: cd.clustered_decode_cuda(**x, **kw))
    cd_plain = time_ms(torch, lambda: cd.clustered_decode_plain(**x, **kw))
    cd_lib = time_ms(torch, sdpa_yardstick(torch, x))
    x1 = dict(x, q=x["q"][:, 0].contiguous(), chunk_len=None)
    cd_ms1 = time_ms(torch, lambda: cd.clustered_decode_cuda(**x1, **kw))
    nb, fl_qk, fl_pv = decode_work(x)
    # bf16 q.k products are exact in f32, so bf16 tensor cores with f32
    # accumulation give the same scores; p is f32, so p.v is f32 work
    cd_bound, cd_by = bound(nb, [(fl_qk, PEAK_BF16_FLOP_PER_S),
                                 (fl_pv, PEAK_F32_FLOP_PER_S)])
    # paged: the phase-3 mixed shape (130 rows in a 256-row bucket) and
    # a decode-only step (one row per slot, bucket 4)
    pg = time_paged(torch, pcd, x, CL_SLOTS, N_BUCKET)
    pg1 = time_paged(torch, pcd, x, [1] * B, B)
    da_ms = time_ms(torch, lambda: da.distance_argmin_cuda(xa, ca,
                                                           metric="l1"))
    da_plain = time_ms(torch, lambda: da.distance_argmin_plain(
        xa, ca, metric="l1"), n=20, warm=2)
    da_ms_l2 = time_ms(torch, lambda: da.distance_argmin_cuda(xa, ca,
                                                              metric="l2"))
    da_bytes = 4 * (N_PTS * D_PTS + K_PTS * D_PTS + 2 * N_PTS)
    da_flops = N_PTS * K_PTS * (3 * D_PTS + 1)         # |x-c|, sum, compare
    da_bound, da_by = bound(da_bytes, [(da_flops, PEAK_F32_FLOP_PER_S)])
    return {
        "clustered_decode": dict(ms=cd_ms, plain_ms=cd_plain,
                                 library_ms=cd_lib, bound_ms=cd_bound,
                                 bound_by=cd_by, bytes=nb,
                                 flops_qk=fl_qk, flops_pv=fl_pv,
                                 decode_form_ms=cd_ms1),
        "paged_clustered_decode": dict(pg, decode_only=pg1),
        "distance_argmin": dict(ms=da_ms, plain_ms=da_plain, library_ms=None,
                                bound_ms=da_bound, bound_by=da_by,
                                bytes=da_bytes, flops=da_flops,
                                l2_ms=da_ms_l2),
    }


def main() -> int:
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    say(smi)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import clustered_decode as cd
    from repro_torch.kernels import distance_argmin as da
    from repro_torch.kernels import paged_clustered_decode as pcd
    from repro_torch.runtime.kv_pool import PagedKVConfig

    record = {"card": smi, "kind": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    t_all = time.perf_counter()

    # phase 2: build
    t0 = time.perf_counter()
    built = _build.build_all()
    say(f"build: {time.perf_counter() - t0:.1f} s "
        + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()))
    record["build_s"] = built
    record["ptxas"] = dict(_build.BUILD_LOG)

    # phase 3: kernels vs plain
    cd_err = check_clustered_decode(torch, cd, dev)
    pcd_err = check_paged_decode(torch, cd, pcd, dev)
    da_err, xa, ca = check_distance_argmin(torch, da, dev)

    # phase 4: small model, card vs CPU
    check_small_model(torch, dev)

    # phase 5: serve
    serve, params = serve_qwen3(torch, dev, smi)
    record["serve"] = serve

    # phase 5b: the same requests through the paged engine
    paged = serve_qwen3(torch, dev, smi, PagedKVConfig(block_size=16),
                        params)[0]
    del params
    record["serve_paged"] = paged
    record["paged_vs_dense_first_diff"] = compare_tokens(serve, paged)

    # phase 6: k-medians through the kernel
    km = kmedians(torch, dev)
    record["kmedians"] = km

    # phase 7: times
    tm = timings(torch, cd, pcd, da, dev, xa, ca)
    record["times"] = tm
    for name, v in tm.items():
        say(f"[{smi}] {name}: kernel_ms {v['ms']:.4f} plain_ms "
            f"{v['plain_ms']:.4f} library_ms {v['library_ms']} bound_ms "
            f"{v['bound_ms']:.4f} ({v['bound_by']})")
    v = tm["paged_clustered_decode"]["decode_only"]
    say(f"[{smi}] paged_clustered_decode decode-only (4 rows): kernel_ms "
        f"{v['ms']:.4f} plain_ms {v['plain_ms']:.4f} library_ms "
        f"{v['library_ms']:.4f} bound_ms {v['bound_ms']:.4f} "
        f"({v['bound_by']}); clustered_decode one-token form "
        f"{tm['clustered_decode']['decode_form_ms']:.4f}")
    say(f"clustered_decode launches per dense engine step and "
        f"paged_clustered_decode per paged engine step: "
        f"{serve['n_layers']}; distance_argmin: 0 per engine step (serving "
        "clusters with the plain assignment), "
        f"{km['launches']} in the k-medians fit")
    record["seconds"] = time.perf_counter() - t_all

    kernels = [
        dict(name="clustered_decode", route="cuda",
             source="src/repro_torch/csrc/clustered_decode.cu",
             replaces="src/repro/kernels/clustered_decode.py:107",
             launches=serve["launches"]["clustered_decode"],
             max_abs_err=cd_err, ms=tm["clustered_decode"]["ms"],
             plain_ms=tm["clustered_decode"]["plain_ms"],
             bound_ms=tm["clustered_decode"]["bound_ms"],
             bound_by=tm["clustered_decode"]["bound_by"],
             library_ms=tm["clustered_decode"]["library_ms"]),
        dict(name="paged_clustered_decode", route="cuda",
             source="src/repro_torch/csrc/paged_clustered_decode.cu",
             replaces="src/repro/kernels/paged_clustered_decode.py:53",
             launches=paged["launches"]["paged_clustered_decode"],
             max_abs_err=pcd_err, ms=tm["paged_clustered_decode"]["ms"],
             plain_ms=tm["paged_clustered_decode"]["plain_ms"],
             bound_ms=tm["paged_clustered_decode"]["bound_ms"],
             bound_by=tm["paged_clustered_decode"]["bound_by"],
             library_ms=tm["paged_clustered_decode"]["library_ms"]),
        dict(name="distance_argmin", route="cuda",
             source="src/repro_torch/csrc/distance_argmin.cu",
             replaces="src/repro/kernels/distance_argmin.py:36",
             launches=km["launches"], max_abs_err=da_err,
             ms=tm["distance_argmin"]["ms"],
             plain_ms=tm["distance_argmin"]["plain_ms"],
             bound_ms=tm["distance_argmin"]["bound_ms"],
             bound_by=tm["distance_argmin"]["bound_by"],
             library_ms=None),
    ]
    record["kernels"] = {k["name"]: k for k in kernels}
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1,
                                                    default=float))
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
