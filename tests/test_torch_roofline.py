"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``):

* ``analysis``: under the reference's TPU constants, the port's
  ``analyze_record`` / ``suggestion`` / ``table`` give the reference's
  rows for synthetic train / prefill / decode / MoE / skipped / error
  records; the only difference is ``fits_80gb`` against ``fits_16gb``
  (and the one-card mesh name).
* ``model_flops_global`` and the decode floor equal the reference's bit
  for bit for every ``ARCH_IDS`` x ``SHAPES`` cell, each package's
  ``info`` from its own ``param_count``, ``active_param_count`` and
  ``cache_struct``.
* ``op_count``: its ``matmul_flops`` equal a hand count and
  ``torch.utils.flop_counter.FlopCounterMode`` for TINY's decode,
  prefill and train steps; its byte rules give hand numbers on single
  ops.
* ``work``: the kernels' work models give PERF.md §6's bound ms at the
  kernel table's shapes (``chip_smoke.py``'s phase-7 inputs, built on the
  CPU).
"""

import importlib.util
import json
import math
import threading
from pathlib import Path

import jax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import _torch_ref  # noqa: F401  (one torch thread, the JAX cache)
from repro import configs as configs_ref
from repro.launch import steps as steps_ref
from repro.models.config import SHAPES as SHAPES_REF
from repro.roofline import analysis as analysis_ref
from repro_torch import configs
from repro_torch.launch import dryrun, steps
from repro_torch.models.config import SHAPES, ModelConfig, ShapeCell
from repro_torch.roofline import analysis, op_count, work

ROOT = Path(__file__).resolve().parents[1]
TPU = dict(PEAK_FLOPS=analysis_ref.PEAK_FLOPS, HBM_BW=analysis_ref.HBM_BW,
           HBM_BYTES=16e9)
TINY = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
                   pad_vocab_multiple=16, dtype="float32")


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------


def _stats(flops, nbytes):
    return {"flops": flops, "hbm_bytes": nbytes, "collectives": {},
            "unknown_trip_loops": 0}


def _synthetic():
    """(name, record) pairs in the reference's layout, ``hlo_stats``; no
    collective, as no one-card record holds one."""
    mem = {"argument_bytes": 9e9, "output_bytes": 2e9, "temp_bytes": 4e9,
           "alias_bytes": 1e9}
    base = {"mesh": "16x16", "n_devices": 256, "memory_analysis": mem}
    return [
        ("train", dict(base, arch="qwen3-4b", shape="train_4k",
                       info={"params": 4.0e9, "active_params": 4.0e9},
                       hlo_stats=_stats(3.1e14, 2.0e11))),
        ("prefill", dict(base, arch="gemma2-27b", shape="prefill_32k",
                         info={"params": 2.7e10, "active_params": 2.7e10,
                               "cache_bytes": 3e10},
                         hlo_stats=_stats(2.4e14, 9.0e10))),
        ("decode", dict(base, arch="mamba2-2.7b", shape="decode_32k",
                        info={"params": 2.7e9, "active_params": 2.7e9,
                              "cache_bytes": 5e9},
                        hlo_stats=_stats(3.0e9, 4.0e8),
                        memory_analysis=dict(mem, temp_bytes=20e9))),
        ("moe", dict(base, arch="qwen2-moe-a2.7b", shape="decode_32k",
                     info={"params": 1.43e10, "active_params": 2.7e9,
                           "cache_bytes": 2e10},
                     hlo_stats=_stats(1.0e11, 8.0e9))),
        ("skipped", {"arch": "qwen3-4b", "shape": "long_500k",
                     "mesh": "16x16", "skipped": "pure full-attention"}),
        ("error", {"arch": "gemma3-4b", "shape": "train_4k",
                   "mesh": "16x16", "error": "ValueError: x"}),
    ]


def _port(rec):
    """The reference record as the port writes it: one-card mesh name,
    ``op_stats`` in ``hlo_stats``' place."""
    out = dict(rec, mesh="1")
    if "hlo_stats" in out:
        out["op_stats"] = out.pop("hlo_stats")
    return out


def _as_ref_row(row):
    out = dict(row, mesh="16x16")
    out["fits_16gb"] = out.pop("fits_80gb")
    return out


@pytest.fixture
def tpu_constants(monkeypatch):
    for k, v in TPU.items():
        monkeypatch.setattr(analysis, k, v)


@pytest.mark.parametrize("name", [n for n, _ in _synthetic()])
def test_analysis_rows_equal_reference(tpu_constants, name):
    rec = dict(_synthetic())[name]
    want = analysis_ref.analyze_record(rec)
    got = analysis.analyze_record(_port(rec))
    if want is None:
        assert got is None
        return
    assert _as_ref_row(got) == want
    assert analysis.suggestion(got) == analysis_ref.suggestion(want)


def test_table_equals_reference(tpu_constants, tmp_path):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    for name, rec in _synthetic():
        (ref_dir / f"{name}.json").write_text(json.dumps(rec))
        (port_dir / f"{name}.json").write_text(json.dumps(_port(rec)))
    want = analysis_ref.table(str(ref_dir), "16x16")
    got = analysis.table(str(port_dir), "1")
    assert got.replace("fits 80GB", "fits 16GB") == want
    w, g = (f(str(d)) for f, d in (
        (analysis_ref.pick_hillclimb_cells, ref_dir),
        (analysis.pick_hillclimb_cells, port_dir)))
    assert _as_ref_row(g["worst"]) == w["worst"]
    assert g["collective"] is None


def test_measured_rows_give_the_fraction():
    """A record holding a run on the card adds the ideal, the measured
    step and their ratio."""
    rec = _port(dict(_synthetic())["decode"])
    rec = dict(rec, n_devices=1, measured_step_s=0.5)
    row = analysis.analyze_record(rec)
    assert row["ideal_s"] == analysis.ideal_step_s(rec)
    assert row["measured_fraction"] == round(row["ideal_s"] / 0.5, 4)


def _info_ref(arch, cell):
    cfg = configs_ref.get_config(arch)
    info = {"active_params": steps_ref.active_param_count(cfg)}
    if cell.step == "decode":
        cs = steps_ref.cache_struct(cfg, cell, steps_ref.StepOptions())
        info["cache_bytes"] = int(sum(math.prod(x.shape) * x.dtype.itemsize
                                      for x in jax.tree.leaves(cs)))
    return info


def _info_port(arch, cell):
    cfg = configs.get_config(arch)
    info = {"active_params": steps.active_param_count(cfg)}
    if cell.step == "decode":
        info["cache_bytes"] = steps.cache_bytes(steps.cache_struct(cfg,
                                                                   cell))
    return info


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_flops_and_decode_floor_bit_equal(monkeypatch, arch):
    """Each package's own counts: MODEL_FLOPS equal bit for bit, and the
    decode floor (the reference's ``(2·active + cache_bytes) / HBM_BW``,
    ``analysis.py:75–78``, against its compute floor) too, under the
    reference's constants."""
    for k, v in TPU.items():
        monkeypatch.setattr(analysis, k, v)
    for shape in SHAPES:
        ref = {"shape": shape, "n_devices": 1,
               "info": _info_ref(arch, SHAPES_REF[shape])}
        got = {"shape": shape, "n_devices": 1,
               "info": _info_port(arch, SHAPES[shape])}
        assert got["info"] == ref["info"], shape
        mf = analysis_ref.model_flops_global(ref)
        assert analysis.model_flops_global(got) == mf
        t_ideal = mf / analysis_ref.PEAK_FLOPS
        if SHAPES_REF[shape].step == "decode":
            floor = (2.0 * ref["info"]["active_params"]
                     + ref["info"]["cache_bytes"])
            t_ideal = max(t_ideal, floor / analysis_ref.HBM_BW)
        assert analysis.ideal_step_s(got) == t_ideal


# ---------------------------------------------------------------------------
# op_count
# ---------------------------------------------------------------------------


def _layer_mm(rows, kv_len):
    """TINY's matmul FLOPs of one layer's forward over ``rows`` query
    rows: the q, k, v and o projections, q·k and p·v over ``kv_len`` keys
    a row, the gated MLP (gate, up, down); and the down projection's
    share."""
    c = TINY
    d, hq, hkv, dh, f = (c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
                         c.d_ff)
    down = 2 * rows * f * d
    return (2 * rows * d * (2 * hq * dh + 2 * hkv * dh)
            + 2 * 2 * rows * hq * dh * kv_len + 2 * rows * 2 * d * f
            + down), down


def _lm_mm(rows):
    return 2 * rows * TINY.d_model * TINY.padded_vocab


def _count(cell, opts):
    """The step of ``cell`` on meta under both counters."""
    params, batch, cache, opt_state, step = dryrun.build_step(
        TINY, cell, opts, torch.device("meta"))
    with FlopCounterMode(display=False) as fc, op_count.OpCounter() as oc:
        dryrun.run_step(step, cell, params, batch, cache, opt_state)
    return oc.stats(), fc.get_total_flops()


@pytest.mark.parametrize("kind,remat", [("decode", True), ("prefill", True),
                                        ("train", True), ("train", False)])
def test_matmul_flops_equal_hand_count_and_flop_counter(kind, remat):
    """Hand counts of what the eager steps multiply.  Decode: one token a
    row against the whole cache.  Prefill: every key chunk, the logits of
    the last row.  Train: each forward product and its two backward
    products; the loss chunks always run under checkpoint (their
    vocabulary projection is recomputed, over rows padded to the loss
    chunk); under remat each layer is recomputed too, but for its MLP down
    projection, whose output no backward product reads (torch's
    non-reentrant checkpoint stops recomputing once the saved tensors are
    back)."""
    b, s = 2, 32
    cell = ShapeCell(kind, s, b, kind)
    opts = steps.StepOptions(remat=remat)
    stats, fc = _count(cell, opts)
    n = TINY.n_layers
    if kind == "decode":
        hand = n * _layer_mm(b, s)[0] + _lm_mm(b)
    elif kind == "prefill":
        hand = n * _layer_mm(b * s, s)[0] + _lm_mm(b)
    else:
        layer, down = _layer_mm(b * s, s)
        ce_rows = b * -(-s // opts.loss_chunk) * opts.loss_chunk
        hand = 3 * n * layer + 4 * _lm_mm(ce_rows)
        if remat:
            hand += n * (layer - down)
    assert stats["matmul_flops"] == hand
    assert stats["matmul_flops"] == fc


def _one(fn, *args):
    with op_count.OpCounter() as oc:
        fn(*args)
    return oc.stats()


def test_byte_rules_on_single_ops():
    f4 = 4
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    st = _one(torch.mm, a, b)
    assert st["matmul_flops"] == st["flops"] == 2 * 8 * 4 * 16
    assert st["hbm_bytes"] == f4 * (8 * 16 + 16 * 4 + 8 * 4)
    x = torch.randn(32, 64)
    st = _one(lambda t: t.view(64, 32).t()[2:5], x)      # views only
    assert (st["flops"], st["hbm_bytes"], st["aten_ops"]) == (0, 0, 0)
    st = _one(lambda t: t[2:5].clone(), x)               # a slice copied
    assert st["hbm_bytes"] == 2 * f4 * 3 * 64
    idx = torch.tensor([1, 7, 3])
    st = _one(lambda t: t.index_select(0, idx), x)       # a gather
    assert st["hbm_bytes"] == f4 * 3 * 64 and st["flops"] == 3 * 64
    vals = torch.randn(3, 64)
    st = _one(lambda t: t.index_put_((idx,), vals), x)   # a scatter
    assert st["hbm_bytes"] == 2 * (8 * 3 + f4 * 3 * 64)
    st = _one(lambda t: t[4:7].copy_(vals), x)           # a slice write
    assert st["hbm_bytes"] == 2 * f4 * 3 * 64
    col = torch.randn(32, 1)
    st = _one(torch.add, x, col)                         # a broadcast read
    assert st["flops"] == 32 * 64
    assert st["hbm_bytes"] == f4 * (32 * 64 + 32 + 32 * 64)
    st = _one(lambda t: t.sum(1), x)                     # a reduction
    assert st["flops"] == 32 * 64 and st["hbm_bytes"] == f4 * (32 * 64 + 32)


def test_kernel_wrappers_count_alike_on_cpu_and_meta():
    """A kernel wrapper under the counter records one launch with its
    work model, on the CPU (its plain version's ops silenced) and on
    meta (shapes only) alike, and leaves ``launches`` (the card's) at
    0."""
    from repro_torch.kernels import ops

    sm = _smoke()
    x = sm.decode_inputs(torch, "cpu", torch.float32)
    xm = {k: (v.to("meta") if torch.is_tensor(v) else v)
          for k, v in x.items()}
    ops.reset_launches()
    got = {}
    for name, xx in (("cpu", x), ("meta", xm)):
        with op_count.OpCounter() as oc:
            out = ops.clustered_decode(**xx, scale=0.1)
        assert out.shape == xx["q"].shape and out.device == xx["q"].device
        got[name] = oc.stats()
    assert got["cpu"]["aten_ops"] == got["meta"]["aten_ops"] == 0
    k_cpu = got["cpu"]["kernels"]["clustered_decode"]
    k_meta = got["meta"]["kernels"]["clustered_decode"]
    assert k_cpu["launches"] == k_meta["launches"] == 1
    assert k_cpu["bytes"] == k_meta["bytes"]
    assert k_cpu["flops"] < k_meta["flops"]     # empty clusters, unwritten
    assert ops.launch_counts()["clustered_decode"] == 0


def test_wrappers_find_the_counter_in_force_on_their_thread():
    """``op_count.active`` is the innermost counter entered on this thread
    (None outside, on other threads, and after the last exits); a wrapper
    called with none in force records nothing anywhere."""
    from repro_torch.kernels import ops

    x = _smoke().decode_inputs(torch, "cpu", torch.float32)
    seen = []
    assert op_count.active() is None
    with op_count.OpCounter() as outer:
        assert op_count.active() is outer
        with op_count.OpCounter() as inner:
            assert op_count.active() is inner
            t = threading.Thread(target=lambda: seen.append(
                op_count.active()))
            t.start()
            t.join()
            ops.clustered_decode(**x, scale=0.1)
        assert op_count.active() is outer
    assert op_count.active() is None and seen == [None]
    assert inner.stats()["kernels"]["clustered_decode"]["launches"] == 1
    before = (inner.stats(), outer.stats())
    ops.clustered_decode(**x, scale=0.1)
    assert (inner.stats(), outer.stats()) == before
    assert "clustered_decode" not in outer.stats()["kernels"]


# ---------------------------------------------------------------------------
# work: the bound column of PERF.md §6's kernel table
# ---------------------------------------------------------------------------


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_work_models_give_the_kernel_table_bounds():
    """Bound ms (4 decimals) and what bounds it, as PERF.md §6's table
    states them (B3 at its all-words figures where the voting points come
    from random card data)."""
    sm = _smoke()
    bf16 = torch.bfloat16
    x = sm.decode_inputs(torch, "cpu", bf16)
    xs = dict(x, chunk_len=torch.tensor(sm.CL_SERVE, dtype=torch.int32))
    x1 = dict(x, q=x["q"][:, 0].contiguous(), chunk_len=None)
    got = {"B1 mixed": work.clustered_decode_work(**x),
           "B1 serve-like": work.clustered_decode_work(**xs),
           "B1 one-token": work.clustered_decode_work(**x1)}
    for name, cl, bucket in (("B2 mixed", sm.CL_SLOTS, sm.N_BUCKET),
                             ("B2 decode-only", [1] * sm.B, sm.B)):
        args, rows, n_mapped = sm.paged_inputs(torch, x, cl, bucket)
        got[name] = work.paged_clustered_decode_work(**args)
        assert got[name].detail["rows"] == len(rows)
        assert got[name].detail["mapped_blocks"] == n_mapped
    args, _, needed = sm.quota_inputs(torch, "cpu", bf16)
    got["B2 quota"] = work.paged_clustered_decode_work(**args)
    assert got["B2 quota"].detail["mapped_blocks"] == needed
    q, k, v = sm.decode_cache(torch, "cpu", bf16)
    got["B5"] = work.flash_decode_work(q, k, v, sm.FD_T)
    for metric in ("l1", "l2"):
        got[f"B4 {metric}"] = work.distance_argmin_work(
            sm.N_PTS, sm.D_PTS, sm.K_PTS, metric)
    for name, m, kk, bits in sm.MED_CASES[:2]:
        n = sm.C + sm.R
        u = torch.empty(m, n, sm.DH, dtype=torch.int64, device="meta")
        got[f"B3 {name}"] = work.bitserial_median_work(
            u, torch.zeros(m, n, dtype=torch.int32), kk, torch.ones(m, n),
            bits=bits)
    u = torch.empty(sm.N_PTS, sm.D_PTS, dtype=torch.int64, device="meta")
    got["B3 streamed"] = work.bitserial_median_work(
        u, torch.zeros(sm.N_PTS, dtype=torch.int32), sm.K_PTS, None, bits=32)
    _, layers, heads, s, plen = sm.admission_cases()[0]
    u = torch.empty(layers, heads, s, sm.DH, dtype=torch.int64,
                    device="meta")
    w = (torch.arange(s) < plen - (sm.R - 32)).float().expand(layers, heads,
                                                               s)
    got["B3 admission"] = work.bitserial_median_work(
        u, torch.zeros(layers, heads, s, dtype=torch.int32), sm.C, w,
        bits=16)
    table = {"B1 mixed": (0.0028, "bytes"), "B1 serve-like": (0.0028, "bytes"),
             "B1 one-token": (0.0016, "bytes"),
             "B2 mixed": (0.0018, "bytes"),
             "B2 decode-only": (0.0010, "bytes"),
             "B2 quota": (0.0054, "bytes"), "B5": (0.0074, "bytes"),
             "B4 l1": (0.0661, "operations"),
             "B4 l2": (0.0406, "operations"),
             "B3 compaction": (0.1362, "bytes"),
             "B3 absorb": (0.0312, "bytes"),
             "B3 streamed": (0.0413, "bytes"),
             "B3 admission": (0.1036, "bytes")}
    for name, (ms, by) in table.items():
        b_ms, b_by = got[name].bound()
        assert (round(b_ms, 4), b_by) == (ms, by), name


def test_dryrun_shape_bound():
    """B1 at 5u's cell (128 slots, one token, C 512, R 256, bf16): 406.8
    MB moved, bound by bytes, whatever the data; on meta the served worst
    case (every centroid, the whole ring) is what a full ring with every
    centroid counted needs."""
    sm = _smoke()
    geo = sm.DRY_GEO
    x = sm.decode_inputs(torch, "cpu", torch.bfloat16, geo=geo)
    x = dict(x, q=x["q"][:, 0].contiguous(), chunk_len=None)
    w = work.clustered_decode_work(**x)
    xm = {k: (v.to("meta") if torch.is_tensor(v) else v)
          for k, v in x.items()}
    wm = work.clustered_decode_work(**xm)
    assert w.nbytes == wm.nbytes == 406848512
    assert w.bound()[1] == wm.bound()[1] == "bytes"
    full = dict(x, counts=torch.ones_like(x["counts"]),
                cov=x["t"] + 1 - sm.R)
    assert work.clustered_decode_work(**full).flops == wm.flops
    assert w.flops < wm.flops
