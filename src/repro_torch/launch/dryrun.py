"""One-card dry run (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device meta \\
        [--arch qwen3-4b] [--shape decode_32k] [--kv-mode clustered]

For each architecture × ``SHAPES`` cell, builds the cell's step from
``launch/steps.py`` and counts it: the step runs on the ``meta`` device
under ``roofline.op_count.OpCounter``, so nothing is allocated and a
full-width step counts in seconds.  The count (``op_stats``) takes the
place of the reference's ``hlo_stats``: eager PyTorch builds no HLO to
parse.  The record keeps the reference's keys; its ``memory_analysis``
is the step's own tensors: arguments (weights, batch, cache; for train
the AdamW state too), outputs, and what the step writes in place
(``alias_bytes``: the decode cache; for train the parameters and
moments).  ``temp_bytes`` is null on ``meta``.

On ``cuda`` (the default), a cell whose arguments and outputs fit the
card's 80 GB (``roofline.analysis``'s ``fits_80gb``) also runs there, the
twin of the reference's compiled artifact: the cache filled as a served
slot at position seq_len - 1 holds it (random keys and values, every
centroid with a count > 0, the ring full), 2 warm steps, then 10 steps
timed with CUDA events (the median is ``measured_step_s``), the peak
allocation above the arguments (``temp_bytes``), the kernel launches a
step, one step under ``torch.profiler`` (where its time goes: the host's
time to enqueue it, the device's busy time and idle share, the kernels of
most device time) and one more under the counter (``card_op_stats``).

``--mesh pod`` / ``multipod`` / ``both`` count **one rank's** step of each
cell on a (data=16, model=16) / (pod=2, data=16, model=16) mesh, on
``meta`` only, with no world: a ``launch.mesh.StandInMesh`` at rank
coordinate 0, ``launch.steps.lower_step``'s step with the reference's
options (``pick_options``).  The rank's arguments are its blocks by the
reference's placements (parameters and, for train, both AdamW moments by
``tree_param_specs``, the batch by ``batch_pspec``, a decode cache by
``cache_pspecs``), so ``argument_bytes`` is the reference's per-device
``argument_size_in_bytes`` where the dtypes agree (the port trains its
weights in the config's dtype, the reference f32 masters).  The rules'
collectives move nothing on ``meta`` and the counter records each
(``op_stats["collectives"]``: bytes by kind, the reference's
``hlo_stats["collectives"]``; ``collective_calls``).  The rank's FLOPs
and bytes are the port's own: its design splits compute over rows only
(the model axis shards storage, ``launch.steps``), so they are the row
shard's whole-width step, where the reference's partitioner splits over
``model`` too.  A serving cell's step gathers its parameters and its
cache rows' blocks whole and computes its rows.  The records' tags are
the reference's, ``{arch}__{shape}__16x16`` / ``__2x16x16``; a mesh cell
on ``--device cuda`` is refused (it would need 256 / 512 cards).

``--moe-impl`` takes the reference's impls and sets the config's, as the
reference's dry run does; with no mesh every impl reaches the same
one-shard dispatch (``repro_torch.models.moe``), ``a2a`` through its
sharded fallback, as the reference's ``apply_moe`` does without a mesh, so
the counts do not change.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.core import tree as tree_mod
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch.mesh import StandInMesh, production_shape
from repro_torch.models import transformer as tfm
from repro_torch.models.config import SHAPES, ModelConfig, ShapeCell
from repro_torch.models.layers import cdtype, resolve_device
from repro_torch.optim import adamw
from repro_torch.roofline import analysis
from repro_torch.roofline.op_count import OpCounter
from repro_torch.sharding import rules as shard_rules

# long_500k requires sub-quadratic serving; pure full-attention archs are
# skipped per the brief (documented in DESIGN.md §7)
LONG_OK = {"mamba2-2.7b", "recurrentgemma-9b", "gemma3-4b", "gemma2-27b"}

MOE_IMPLS = ("global", "sharded", "a2a")
WARM_STEPS, TIMED_STEPS = 2, 10
# activations may take 9/16 of a device's HBM, the reference's rule for
# choosing the training microbatch
ACT_BUDGET = analysis.HBM_BYTES * 9 / 16
ONE_CARD = StandInMesh({"data": 1, "model": 1})


def cell_is_skipped(arch: str, shape_name: str):
    if shape_name == "long_500k" and arch not in LONG_OK:
        return ("pure full-attention arch: 500k-token decode is out of its "
                "design envelope (no sliding-window/SSM path)")
    return None


def pick_microbatch(cfg: ModelConfig, cell: ShapeCell,
                    budget_bytes: float = ACT_BUDGET) -> int:
    """The reference's ``pick_microbatch`` on one device, under one card's
    activation budget ``budget_bytes``."""
    return steps.pick_microbatch(cfg, ONE_CARD, cell, budget_bytes)


def pick_options(cfg: ModelConfig, cell: ShapeCell,
                 **overrides) -> steps.StepOptions:
    """The reference's ``pick_options`` on one device: no kv repeat (the
    model axis is 1), the microbatch of :func:`pick_microbatch`."""
    opts = steps.StepOptions(microbatch=pick_microbatch(cfg, cell))
    return dataclasses.replace(opts, **overrides)


def serving_params(params, cfg: ModelConfig):
    """Floating leaves in ``cfg.dtype``, as the reference's ``lower_step``
    holds serving weights (fp32 masters exist only in training)."""
    dt = cdtype(cfg)
    return tree_mod.map_(lambda t: t.to(dt) if t.is_floating_point()
                         and t.dtype != dt else t, params)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_mod.leaves(tree)
               if torch.is_tensor(t))


def build_step(cfg, cell, opts, device, params=None):
    """(params, batch, cache, opt_state, step fn) of the cell on
    ``device``: meta tensors, or on the card random ones (the cache as a
    served slot holds it)."""
    meta = device.type == "meta"
    if params is None:
        gen = torch.Generator() if meta else \
            torch.Generator(device=device).manual_seed(0)
        params = tfm.init_params(gen, cfg, device=device)
    if cell.step != "train":
        params = serving_params(params, cfg)
    batch = steps.batch_struct(cfg, cell)
    if not meta:
        batch = _fill_batch(batch, cfg, cell, device)
    cache = opt_state = None
    if cell.step == "decode":
        cache = steps.cache_struct(cfg, cell, opts)
        if not meta:
            cache = _fill_cache(cache, cell, device)
        step = steps.make_decode_step(cfg, opts)
    elif cell.step == "prefill":
        step = steps.make_prefill_step(cfg, cell, opts)
    else:
        opt_state = adamw.init(params)
        step = steps.make_train_step(cfg, adamw.AdamWConfig(), opts)
    return params, batch, cache, opt_state, step


def run_step(step, cell, params, batch, cache, opt_state):
    if cell.step == "decode":
        return step(params, cache, batch)
    if cell.step == "prefill":
        return step(params, batch)
    return step(params, opt_state, batch)


def _fill_batch(batch, cfg, cell, device):
    g = torch.Generator(device=device).manual_seed(1)
    out = {}
    for k, v in batch.items():
        if k == "t":
            out[k] = torch.tensor(cell.seq_len - 1, dtype=v.dtype,
                                  device=device)
        elif v.is_floating_point():
            out[k] = torch.randn(v.shape, generator=g, device=device,
                                 dtype=torch.float32).to(v.dtype)
        else:
            out[k] = torch.randint(0, cfg.vocab, v.shape, generator=g,
                                   device=device, dtype=v.dtype)
    return out


def _fill_cache(cache, cell, device):
    """The meta cache on the card, as a served slot at position seq_len - 1
    holds it: random keys, values and states; every centroid counted
    (counts in [1, 64]); the frontier ``cov`` where the full ring starts,
    so every ring entry is visible; int8 payloads random, scales 1."""
    g = torch.Generator(device=device).manual_seed(2)
    t_next = cell.seq_len

    def fill(path, v):
        name = path[-1]
        if name == "cov":
            return torch.full(v.shape, max(t_next - ring, 0), dtype=v.dtype,
                              device=device)
        if name == "counts":
            return torch.randint(1, 65, v.shape, generator=g, device=device
                                 ).to(v.dtype)
        if name.endswith("_scale"):
            return torch.ones(v.shape, dtype=v.dtype, device=device)
        if not v.is_floating_point():
            return torch.randint(-127, 128, v.shape, generator=g,
                                 device=device).to(v.dtype)
        return torch.randn(v.shape, generator=g, device=device,
                           dtype=torch.float32).to(v.dtype)

    def walk(path, x):
        nonlocal ring
        if torch.is_tensor(x):
            return fill(path, x)
        if isinstance(x, dict):
            if "k_tail" in x:
                ring = x["k_tail"].shape[1]
            return {k: walk(path + (k,), v) for k, v in x.items()}
        return type(x)(walk(path + (str(i),), v) for i, v in enumerate(x))

    ring = 0
    return walk((), cache)


def smi_line():
    """The card's name and power limit as nvidia-smi gives them, or
    None without one."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def count_step(cfg, cell, opts):
    """One run of the cell's step on meta under the counter: (op_stats,
    memory analysis without temp_bytes, seconds)."""
    t0 = time.time()
    params, batch, cache, opt_state, step = build_step(
        cfg, cell, opts, torch.device("meta"))
    args = [params, batch, cache, opt_state]
    arg_bytes = sum(_nbytes(x) for x in args if x is not None)
    alias = (_nbytes(cache) if cell.step == "decode" else
             _nbytes(params) + _nbytes(opt_state) if cell.step == "train"
             else 0)
    with OpCounter() as counter:
        out = run_step(step, cell, params, batch, cache, opt_state)
    mem = {"argument_bytes": arg_bytes, "output_bytes": _nbytes(out),
           "temp_bytes": None, "alias_bytes": alias}
    return counter.stats(), mem, time.time() - t0


MESHES = {"16x16": False, "2x16x16": True}   # tag -> multi_pod


def _cache_blocks(cache, rules):
    return tree_mod.unflatten(cache, [
        shard_rules.take_block(c, s, rules)
        for c, s in zip(tree_mod.leaves(cache), shard_rules.specs_like(
            cache, steps.cache_pspecs(cache, rules)))])


def count_mesh_step(cfg, cell, opts, shape: dict):
    """One rank's step of the cell on a mesh of ``shape`` (coordinate 0),
    on meta under the counter: (op_stats, memory analysis of the rank's
    blocks without temp_bytes, seconds)."""
    t0 = time.time()
    mesh = StandInMesh(shape)
    step, _ = steps.lower_step(cfg, mesh, cell, opts)
    rules = step.rules
    params = tfm.init_params(torch.Generator(), cfg, device="meta")
    batch = steps.batch_struct(cfg, cell)
    rows = shard_rules.take_rows(batch, step.rows, rules)
    if cell.step == "train":
        blocks, opt = shard_rules.place_train_state(
            params, adamw.init(params), rules)
        args, alias = [blocks, opt, rows], _nbytes(blocks) + _nbytes(opt)
        run = lambda: step(blocks, opt, batch)  # noqa: E731
    else:
        blocks = shard_rules.place_params(serving_params(params, cfg), rules)
        cache = None
        if cell.step == "decode":
            cache = _cache_blocks(steps.cache_struct(cfg, cell, opts), rules)
        args = [blocks, cache, rows]
        alias = _nbytes(cache) if cache is not None else 0
        run = (lambda: step(blocks, batch)) if cache is None else (
            lambda: step(blocks, cache, batch))
    with OpCounter() as counter:
        out = run()
    if cell.step == "train":
        out_bytes = _nbytes(out)
    else:       # the logits of the rank's rows and its block of the cache
        out_bytes = _nbytes(out[0]) + _nbytes(_cache_blocks(out[1], rules))
    mem = {"argument_bytes": sum(_nbytes(a) for a in args if a is not None),
           "output_bytes": out_bytes, "temp_bytes": None,
           "alias_bytes": alias}
    return counter.stats(), mem, time.time() - t0


def profile_step(run) -> dict:
    """One call of ``run`` (a step) under ``torch.profiler``, the card's
    activity only: its wall, the host's time to enqueue it (no
    synchronize inside), the device's busy time (its kernels' time, None
    where the profiler saw none) and idle share, and the 10 kernels of
    most device time ([name, ms, launches])."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6 or None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {"profiled_step_s": wall, "host_enqueue_s": host,
            "device_busy_s": busy,
            "idle_share": None if busy is None else 1 - busy / wall,
            "top_device_ms": [[e.key, e.self_device_time_total / 1e3,
                               e.count] for e in top]}


def run_on_card(cfg, cell, opts, device, params=None) -> dict:
    """The cell's step on the card: 2 warm steps, 10 timed with CUDA
    events (median), the peak allocation above the arguments, the kernel
    launches a step, whether the logits are finite, one step profiled
    (:func:`profile_step`) and one more under the counter."""
    params, batch, cache, opt_state, step = build_step(cfg, cell, opts,
                                                       device, params)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = run_step(step, cell, params, batch, cache, opt_state)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    for _ in range(WARM_STEPS - 1):
        out = run_step(step, cell, params, batch, cache, opt_state)
    ops.reset_launches()
    ms = []
    for _ in range(TIMED_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = run_step(step, cell, params, batch, cache, opt_state)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    launches = {k: (v // TIMED_STEPS if v % TIMED_STEPS == 0
                    else v / TIMED_STEPS)
                for k, v in ops.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated() - base
    logits = out[2]["loss"] if cell.step == "train" else out[0]
    finite = bool(torch.isfinite(logits).all())
    prof = profile_step(lambda: run_step(step, cell, params, batch, cache,
                                         opt_state))
    with OpCounter() as counter:
        run_step(step, cell, params, batch, cache, opt_state)
    del out, logits
    return {"measured_step_s": statistics.median(ms) / 1e3,
            "measured_step_ms": ms, "first_step_s": first_s,
            "temp_bytes": peak, "launches_per_step": launches,
            "logits_finite": finite, "profile": prof,
            "card_op_stats": counter.stats(), "card": smi_line()}


def run_cell(arch: str, shape_name: str, overrides=None, moe_impl=None,
             device=None, params=None, *, cfg: ModelConfig = None,
             cell: ShapeCell = None, mesh: str = "1") -> dict:
    """The cell's record: counted on ``meta``, and on ``cuda`` (the
    default) run on the card as well when it fits.  ``params`` (on the
    card) reuses weights already there; ``cfg`` / ``cell`` replace the
    arch's config and the shape's cell (reduced configs, small cells).
    ``moe_impl`` replaces a MoE config's impl; on one card every impl
    reaches the same dispatch ("a2a" its sharded fallback).  ``mesh``
    "16x16" / "2x16x16" (or a stand-in shape {axis: size}): one rank's
    step of that mesh, on meta only (the module docstring)."""
    if mesh != "1":
        return run_mesh_cell(arch, shape_name, overrides, moe_impl,
                             device, cfg=cfg, cell=cell, mesh=mesh)
    dev = resolve_device(device)
    cfg = cfg or configs.get_config(arch)
    if moe_impl and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, impl=moe_impl))
    cell = cell or SHAPES[shape_name]
    opts = pick_options(cfg, cell, **(overrides or {}))
    t0 = time.time()
    info = {"options": dataclasses.asdict(opts),
            "params": steps.param_count(cfg),
            "active_params": steps.active_param_count(cfg)}
    if cell.step in ("decode", "prefill"):
        info["cache_bytes"] = steps.cache_bytes(
            steps.cache_struct(cfg, cell, opts))
    stats, mem, count_s = count_step(cfg, cell, opts)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "1",
        "n_devices": 1,
        "info": info,
        "trace_s": round(time.time() - t0, 1),
        "compile_s": None,
        "memory_analysis": mem,
        "xla_cost_analysis": {"flops": None, "bytes_accessed": None},
        "op_stats": stats,
    }
    if SHAPES.get(shape_name) != cell:
        result["cell"] = dataclasses.asdict(cell)
    row = analysis.analyze_record(result)
    print(f"[dryrun] {arch} × {shape_name} × 1: count {count_s:.1f}s, "
          f"flops {stats['flops']:.3e}, hbm {stats['hbm_bytes']:.3e} B, "
          f"{stats['aten_ops']} aten ops, kernels "
          f"{ {k: v['launches'] for k, v in stats['kernels'].items()} }")
    print(f"[dryrun] memory: {mem}; device bytes "
          f"{row['device_bytes'] / 1e9:.2f} GB, fits 80 GB "
          f"{row['fits_80gb']}")
    if dev.type == "cuda" and row["fits_80gb"]:
        card = run_on_card(cfg, cell, opts, dev, params)
        result["memory_analysis"]["temp_bytes"] = card.pop("temp_bytes")
        result.update(card)
        row = analysis.analyze_record(result)
        print(f"[dryrun] on {card['card']}: step "
              f"{card['measured_step_s'] * 1e3:.3f} ms (median of "
              f"{TIMED_STEPS}), ideal {row['ideal_s'] * 1e3:.3f} ms, "
              f"fraction {row['measured_fraction']}, temp "
              f"{result['memory_analysis']['temp_bytes'] / 1e9:.3f} GB, "
              f"idle share {card['profile']['idle_share']}")
    return result


def run_mesh_cell(arch: str, shape_name: str, overrides=None,
                  moe_impl=None, device="meta", *, cfg: ModelConfig = None,
                  cell: ShapeCell = None, mesh="16x16") -> dict:
    """One rank's count of the cell on a mesh: ``mesh`` a production tag
    ("16x16", "2x16x16") or a stand-in shape {axis: size}."""
    shape = (production_shape(MESHES[mesh]) if isinstance(mesh, str)
             else dict(mesh))
    tag = "x".join(str(v) for v in shape.values())
    n = math.prod(shape.values())
    if torch.device(device or "cuda").type != "meta":
        raise ValueError(f"the {tag} mesh's cell needs {n} cards: count "
                         "one rank's step with --device meta")
    cfg = cfg or configs.get_config(arch)
    if moe_impl and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, impl=moe_impl))
    cell = cell or SHAPES[shape_name]
    opts = steps.pick_options(cfg, StandInMesh(shape), cell,
                              **(overrides or {}))
    t0 = time.time()
    _, info = steps.lower_step(cfg, StandInMesh(shape), cell, opts)
    stats, mem, count_s = count_mesh_step(cfg, cell, opts, shape)
    result = {
        "arch": arch, "shape": shape_name, "mesh": tag, "n_devices": n,
        "info": info, "trace_s": round(time.time() - t0, 1),
        "compile_s": None, "memory_analysis": mem,
        "xla_cost_analysis": {"flops": None, "bytes_accessed": None},
        "op_stats": stats,
    }
    if SHAPES.get(shape_name) != cell:
        result["cell"] = dataclasses.asdict(cell)
    row = analysis.analyze_record(result)
    print(f"[dryrun] {arch} × {shape_name} × {tag} (rank 0): count "
          f"{count_s:.1f}s, flops {stats['flops']:.3e}, hbm "
          f"{stats['hbm_bytes']:.3e} B, collectives "
          f"{stats['collectives']} in {stats['collective_calls']} calls")
    print(f"[dryrun] memory (rank 0): {mem}; device bytes "
          f"{row['device_bytes'] / 1e9:.2f} GB, fits 80 GB "
          f"{row['fits_80gb']}")
    return result


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="dry run: count each arch x shape cell's step on the "
                    "meta device and, on the card, run the cells that fit "
                    "its 80 GB; with --mesh pod / multipod / both, count "
                    "one rank's step of the 16x16 / 2x16x16 mesh on meta")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--moe-impl", default=None,
                    choices=[None, *MOE_IMPLS],
                    help="the reference's MoE impls; on one card every impl "
                         "reaches the same dispatch (a2a its sharded "
                         "fallback, as the reference's without a mesh), so "
                         "the counts do not change")
    ap.add_argument("--kv-mode", default=None,
                    choices=[None, "exact", "clustered", "int8"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "meta"])
    ap.add_argument("--mesh", default="1",
                    choices=["1", "pod", "multipod", "both"],
                    help="1: one card (the default); pod / multipod / "
                         "both: one rank of the 16x16 / 2x16x16 mesh, "
                         "counted on meta (256 / 512 cards)")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    archs = list(configs.ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"1": ["1"], "pod": ["16x16"], "multipod": ["2x16x16"],
              "both": ["16x16", "2x16x16"]}[args.mesh]
    if args.mesh != "1" and args.device != "meta":
        ap.error(f"--mesh {args.mesh}: the 16x16 mesh needs 256 cards and "
                 "the 2x16x16 mesh 512; count one rank's step with "
                 "--device meta")

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                tag = f"{arch}__{shape}__{mesh}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[dryrun] cached: {tag}")
                    continue
                skip = cell_is_skipped(arch, shape)
                if skip:
                    res = {"arch": arch, "shape": shape, "mesh": mesh,
                           "skipped": skip}
                    print(f"[dryrun] SKIP {tag}: {skip}")
                else:
                    try:
                        ov = ({"kv_mode": args.kv_mode} if args.kv_mode
                              else None)
                        res = run_cell(arch, shape, overrides=ov,
                                       moe_impl=args.moe_impl,
                                       device=args.device, mesh=mesh)
                    except Exception as e:  # noqa: BLE001
                        traceback.print_exc()
                        failures.append(tag)
                        res = {"arch": arch, "shape": shape, "mesh": mesh,
                               "error": f"{type(e).__name__}: {e}"}
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
    if failures:
        print("[dryrun] FAILURES:", failures)
        raise SystemExit(1)
    print("[dryrun] all requested cells done")


if __name__ == "__main__":
    main()
