"""The port's one-card dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun`` and ``steps.lower_step``):

* ``cell_is_skipped`` gives the reference's skips for every ARCH_IDS x
  SHAPES pair.
* ``run_cell(device="meta")`` on the reduced qwen3-4b, qwen2-moe-a2.7b
  and mamba2-2.7b at small cells of each step kind writes the
  reference's record keys (``op_stats`` in ``hlo_stats``' place); its
  ``info`` equals what the reference's ``lower_step`` returns on a 1 x 1
  host mesh, its options with the sharding switches ``fsdp``,
  ``seq_shard`` and ``mla_seq_shard`` (off on one device) included.
* Its FLOPs against ``analyze_hlo`` of the reference's compiled step:
  the total lies within ``TOTAL_RATIO`` (the HLO counts layout ops —
  converts, transposes, broadcasts, the per-layer slices of the stacked
  weights, the cache's dynamic-update-slice — at 1 FLOP an element,
  which eager PyTorch runs as views or not at all); the products (the
  counter's ``matmul_flops`` plus the kernels' work) equal the HLO's dot
  FLOPs exactly for every decode step (clustered too: the reference's
  kernel in interpret mode computes over every entry, as the meta count's
  worst case does) and every prefill, and lie within ``DOT_RATIO`` for
  train (torch's checkpoint recomputes forward products that XLA's remat
  keeps).
* The step's count on the CPU, with the cache filled as the card run
  fills it, equals the meta count.
* At full width on meta, qwen3-4b x decode_32k fits 80 GB in kv_mode
  "clustered" and not in "exact"; ``--device meta`` runs from the
  command line; ``--moe-impl a2a`` counts what ``sharded`` counts (its
  sharded fallback with no mesh, as in the reference).
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ref  # noqa: F401  (one torch thread, the JAX cache)
from repro import configs as configs_ref
from repro.launch import steps as steps_ref
from repro.launch.mesh import make_host_mesh
from repro.models import moe as moe_ref
from repro.models.config import ShapeCell as ShapeCellRef
from repro.roofline import hlo_parse
from repro_torch import bridge, configs
from repro_torch.launch import dryrun
from repro_torch.models import moe
from repro_torch.models.config import SHAPES, ShapeCell
from repro_torch.roofline import analysis
from repro_torch.roofline.op_count import OpCounter

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-4b", "qwen2-moe-a2.7b", "mamba2-2.7b"]
CELLS = {"decode": (256, 4), "prefill": (64, 2), "train": (64, 2)}
OVERRIDES = {"kv_clusters": 16, "kv_tail": 64}
SHARDING_OPTIONS = {"fsdp", "seq_shard", "mla_seq_shard"}
TOTAL_RATIO = (0.25, 1.05)
DOT_RATIO = {("train", a): (1.0, 1.15) for a in ARCHS}


def _reference_skips():
    """The reference dry run's ``LONG_OK`` and ``cell_is_skipped``, taken
    from its source: importing ``repro.launch.dryrun`` sets XLA_FLAGS to
    512 host devices for the whole process."""
    path = ROOT / "src" / "repro" / "launch" / "dryrun.py"
    tree = ast.parse(path.read_text())
    keep = [n for n in tree.body
            if (isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "LONG_OK"
                        for t in n.targets))
            or (isinstance(n, ast.FunctionDef)
                and n.name == "cell_is_skipped")]
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"),
         ns)
    return ns["LONG_OK"], ns["cell_is_skipped"]


def test_cell_is_skipped_equals_reference():
    long_ok, skipped = _reference_skips()
    assert dryrun.LONG_OK == long_ok
    for arch in configs.ARCH_IDS:
        for shape in SHAPES:
            assert dryrun.cell_is_skipped(arch, shape) == skipped(arch,
                                                                  shape)


def _reference(arch, kind, kv):
    """The reference's lower_step on a 1 x 1 host mesh: (info, HLO flops,
    HLO dot flops)."""
    s, b = CELLS[kind]
    cfg = configs_ref.get_reduced(arch)
    cell = ShapeCellRef(f"{kind}_s", s, b, kind)
    mesh = make_host_mesh()
    assert mesh.devices.size == 1
    opts = steps_ref.pick_options(cfg, mesh, cell, kv_mode=kv, **OVERRIDES)
    lowered, info = steps_ref.lower_step(cfg, mesh, cell, opts)
    text = lowered.compile().as_text()
    total = hlo_parse.analyze_hlo(text)["flops"]
    op_flops = hlo_parse._op_flops
    try:
        hlo_parse._op_flops = lambda op, comp: (
            op_flops(op, comp) if op.kind == "dot" else 0.0)
        dots = hlo_parse.analyze_hlo(text)["flops"]
    finally:
        hlo_parse._op_flops = op_flops
    return info, total, dots


def _port(arch, kind, kv):
    s, b = CELLS[kind]
    return dryrun.run_cell(arch, f"{kind}_s", dict(OVERRIDES, kv_mode=kv),
                           device="meta", cfg=configs.get_reduced(arch),
                           cell=ShapeCell(f"{kind}_s", s, b, kind))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind,kv", [("decode", "exact"),
                                     ("decode", "clustered"),
                                     ("prefill", "exact"), ("train", "exact")])
def test_run_cell_on_meta_against_lower_step(arch, kind, kv):
    rec = _port(arch, kind, kv)
    ref_keys = {"arch", "shape", "mesh", "n_devices", "info", "trace_s",
                "compile_s", "memory_analysis", "xla_cost_analysis",
                "hlo_stats"}
    assert ref_keys - {"hlo_stats"} | {"op_stats"} <= set(rec)
    assert set(rec["memory_analysis"]) == {"argument_bytes", "output_bytes",
                                           "temp_bytes", "alias_bytes"}
    assert rec["memory_analysis"]["temp_bytes"] is None
    assert {"flops", "hbm_bytes", "collectives",
            "unknown_trip_loops"} <= set(rec["op_stats"])
    assert (rec["mesh"], rec["n_devices"]) == ("1", 1)

    info_ref, total, dots = _reference(arch, kind, kv)
    opts_ref = dict(info_ref.pop("options"))
    info = dict(rec["info"])
    opts = info.pop("options")
    assert info == info_ref
    assert set(opts_ref) == set(opts) >= SHARDING_OPTIONS
    assert not any(opts_ref[k] for k in SHARDING_OPTIONS)
    assert opts == opts_ref

    st = rec["op_stats"]
    lo, hi = TOTAL_RATIO
    assert lo <= st["flops"] / total <= hi
    products = st["matmul_flops"] + sum(k["flops"]
                                        for k in st["kernels"].values())
    if (kind, arch) in DOT_RATIO:
        lo, hi = DOT_RATIO[(kind, arch)]
        assert lo <= products / dots <= hi
    else:
        assert products == dots


@pytest.mark.parametrize("arch,kind,kv", [("qwen3-4b", "decode", "clustered"),
                                          ("qwen2-moe-a2.7b", "decode",
                                           "clustered"),
                                          ("mamba2-2.7b", "train", "exact")])
def test_filled_cpu_step_counts_as_meta(arch, kind, kv):
    """The card run's inputs built on the CPU (weights, the cache filled
    as a served slot holds it: every centroid counted, the ring full)
    count as meta does: the kernel's data-dependent work is the meta
    count's worst case, and every aten op the same; the logits finite."""
    s, b = CELLS[kind]
    cfg = configs.get_reduced(arch)
    cell = ShapeCell(f"{kind}_s", s, b, kind)
    opts = dryrun.pick_options(cfg, cell, kv_mode=kv, **OVERRIDES)
    counts = {}
    for dev in ("meta", "cpu"):
        params, batch, cache, opt_state, step = dryrun.build_step(
            cfg, cell, opts, torch.device(dev))
        with OpCounter() as oc:
            out = dryrun.run_step(step, cell, params, batch, cache, opt_state)
        counts[dev] = oc.stats()
    assert counts["cpu"] == counts["meta"]
    logits = out[2]["loss"] if kind == "train" else out[0]
    assert bool(torch.isfinite(logits).all())


def test_moe_dispatch_counts_equal_reference_and_run_on_meta():
    """The port's MoE dispatch counts its experts' assignments with a
    scatter-add, which also runs on meta: on the CPU the counts equal the
    reference's ``_dispatch_compute``'s, on meta the dispatch gives every
    output's shape."""
    cfg = dataclasses.replace(configs_ref.get_reduced("qwen2-moe-a2.7b"),
                              dtype="float32")
    cfg_t = dataclasses.replace(configs.get_reduced("qwen2-moe-a2.7b"),
                                dtype="float32")
    p = jax.tree.map(np.asarray, moe_ref.init_moe(jax.random.PRNGKey(0),
                                                  cfg))
    pt = {k: bridge.to_torch(v) for k, v in p.items() if k != "shared"}
    x = np.random.default_rng(4).normal(size=(256, cfg.d_model)).astype(
        np.float32)
    want = moe_ref._dispatch_compute(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x), cfg, 1)[1]
    got = moe._dispatch_compute(pt, torch.from_numpy(x), cfg_t)[1]
    assert torch.equal(got, torch.tensor(np.asarray(want),
                                         dtype=torch.float32))
    assert int(got.sum()) == 256 * cfg.moe.top_k
    pm = {k: v.to("meta") for k, v in pt.items()}
    y, counts, pbar, keep = moe._dispatch_compute(
        pm, torch.empty(256, cfg.d_model, device="meta"), cfg_t)
    assert (y.shape, counts.shape, pbar.shape, keep.shape) == (
        (256, cfg.d_model), (cfg.moe.n_routed,), (cfg.moe.n_routed,), ())
    assert counts.device.type == "meta"


def test_full_width_decode_fits_only_clustered():
    """qwen3-4b x decode_32k on meta: 36 B1 launches a step; the
    clustered cache (C 512 + R 256 a kv head) fits the card with the
    weights, the exact one (32,768 positions) does not."""
    rows = {}
    for kv in ("clustered", "exact"):
        rec = dryrun.run_cell("qwen3-4b", "decode_32k", {"kv_mode": kv},
                              device="meta")
        rows[kv] = analysis.analyze_record(rec)
        launches = rec["op_stats"]["kernels"].get(
            "clustered_decode", {}).get("launches", 0)
        assert launches == (36 if kv == "clustered" else 0)
    assert rows["clustered"]["fits_80gb"] and not rows["exact"]["fits_80gb"]
    assert rows["clustered"]["dominant"] == "memory"


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b"])
def test_moe_impl_a2a_counts_equal_sharded(arch):
    """``--moe-impl a2a`` on one card runs the sharded fallback, as the
    reference's ``apply_moe`` does with no mesh: the meta count of a
    decode cell at full width equals ``sharded``'s, op for op."""
    recs = {impl: dryrun.run_cell(arch, "decode_32k", moe_impl=impl,
                                  device="meta")
            for impl in ("a2a", "sharded")}
    assert recs["a2a"]["op_stats"] == recs["sharded"]["op_stats"]
    assert recs["a2a"]["info"] == recs["sharded"]["info"]


def _cli(*args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--out", str(tmp_path)], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)


def test_cli_meta_writes_records(tmp_path):
    r = _cli("--device", "meta", "--arch", "mamba2-2.7b", "--shape",
             "decode_32k", tmp_path=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "all requested cells done" in r.stdout
    rec = json.loads((tmp_path / "mamba2-2.7b__decode_32k__1.json")
                     .read_text())
    assert rec["mesh"] == "1" and rec["op_stats"]["flops"] > 0
    r = _cli("--device", "meta", "--arch", "qwen3-4b", "--shape",
             "long_500k", tmp_path=tmp_path)
    assert r.returncode == 0
    rec = json.loads((tmp_path / "qwen3-4b__long_500k__1.json").read_text())
    assert rec["skipped"] == _reference_skips()[1]("qwen3-4b", "long_500k")
    r = _cli("--device", "meta", "--arch", "qwen2-moe-a2.7b", "--shape",
             "decode_32k", "--moe-impl", "a2a", tmp_path=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads((tmp_path / "qwen2-moe-a2.7b__decode_32k__1.json")
                     .read_text())
    assert rec["info"]["options"] and rec["op_stats"]["flops"] > 0
    r = _cli("--help", tmp_path=tmp_path)
    assert "--mesh" in r.stdout and "multipod" in r.stdout
    assert "pod" in r.stdout.split("--mesh", 1)[1]
    assert "--device" in r.stdout
