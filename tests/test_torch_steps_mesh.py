"""The mesh helpers of ``repro_torch.launch.steps`` against the
reference's (``repro.launch.steps``), with no world: stand-in meshes of
(data=16, model=16), (pod=2, data=16, model=16), (data=2, model=4) and
(data=8, model=1), every ARCH_IDS x SHAPES cell at full width, every
``kv_mode``.

* ``pick_kv_repeat``, ``pick_microbatch`` and ``pick_options`` (also with
  overrides) equal the reference's;
* ``batch_pspec`` under ``lower_step``'s rules (``step_rules``) equals the
  reference's, entry for entry;
* ``cache_pspecs`` of a cell's decode cache equals the reference's: on
  the reference's own ``cache_struct`` tree (its leaves as meta tensors),
  and on the port's ``cache_struct`` restacked into the reference's
  layout (``bridge``), scan-stacked leaves with their leading None;
* ``lower_step``'s ``info`` equals the reference's keys and values but
  for the cache bytes, which tests/test_torch_steps.py holds.
"""

import dataclasses

import jax
import pytest
import torch

import _torch_ref  # noqa: F401  (one torch thread, the JAX cache)
from repro import configs
from repro.launch import steps as steps_ref
from repro.models.config import SHAPES
from repro.sharding import rules as rules_ref
from repro_torch import bridge
from repro_torch import configs as configs_t
from repro_torch.launch import mesh as mesh_t
from repro_torch.launch import steps
from repro_torch.models.config import SHAPES as SHAPES_T

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 4}, {"data": 8, "model": 1}]
KV_MODES = ("exact", "clustered", "int8")


class RefMesh:
    """The reference's view of a stand-in mesh: ``shape`` and
    ``axis_names``."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _spec(p):
    """A reference PartitionSpec as the port's tuple."""
    return tuple((e,) if isinstance(e, str) else
                 (tuple(e) if e is not None else None) for e in p)


def _ref_rules(cfg, mesh, opts):
    table = rules_ref.default_table("pod" in mesh.shape,
                                    seq_shard=opts.seq_shard)
    if opts.mla_seq_shard:
        table["kvseq"] = ("model",)
    return rules_ref.Rules(mesh, table, fsdp=opts.fsdp)


def _ref_cache_specs(cs, rules):
    specs = steps_ref.cache_pspecs(cs, rules)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jax.tree_util.keystr(kp): _spec(s) for kp, s in flat[0]}


def _port_specs_by_key(tree_meta, rules):
    """The port's ``cache_pspecs`` of a tree in the reference's layout,
    keyed like :func:`_ref_cache_specs`."""
    specs = steps.cache_pspecs(tree_meta, rules)

    def walk(x, key, out):
        if isinstance(x, dict):
            for k in x:
                walk(x[k], f"{key}['{k}']", out)
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(v, f"{key}[{i}]", out)
        elif x is not None:
            out[key] = x
        return out

    return walk(specs, "", {})


def _meta_of(cs):
    """The reference's cache struct as meta tensors, its containers as
    lists and dicts."""
    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        return torch.empty(x.shape, dtype=torch.float32, device="meta")

    return walk(cs)


def _restacked(cache, cfg_t):
    """The port's decode cache's layers in the reference's prefix / scan /
    tail layout (meta tensors)."""
    return bridge._restack(cache["layers"], cfg_t, lambda t, _k: t)


@pytest.mark.parametrize("arch", list(configs.ARCH_IDS))
def test_pick_options_and_batch_specs_match_reference(arch):
    cfg, cfg_t = configs.get_config(arch), configs_t.get_config(arch)
    for shape in SHAPES:
        cell, cell_t = SHAPES[shape], SHAPES_T[shape]
        for m in MESHES:
            ref_mesh, mesh = RefMesh(m), mesh_t.StandInMesh(m)
            assert steps.pick_kv_repeat(cfg_t, mesh) == \
                steps_ref.pick_kv_repeat(cfg, ref_mesh), (shape, m)
            assert steps.pick_microbatch(cfg_t, mesh, cell_t) == \
                steps_ref.pick_microbatch(cfg, ref_mesh, cell), (shape, m)
            for ov in ({}, {"remat": False, "microbatch": 2,
                            "kv_mode": "clustered", "fsdp": True}):
                want = steps_ref.pick_options(cfg, ref_mesh, cell, **ov)
                got = steps.pick_options(cfg_t, mesh, cell_t, **ov)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                rules = steps.step_rules(cfg_t, mesh, got)
                rref = _ref_rules(cfg, ref_mesh, want)
                bw = steps_ref.batch_pspec(cfg, cell, rref)
                bg = steps.batch_pspec(cfg_t, cell_t, rules)
                assert {k: _spec(v) for k, v in bw.items()} == bg, (shape, m)


@pytest.mark.parametrize("arch", list(configs.ARCH_IDS))
def test_cache_pspecs_match_reference(arch):
    cfg, cfg_t = configs.get_config(arch), configs_t.get_config(arch)
    modes = ["exact"] if cfg.is_encdec else list(KV_MODES)
    checked = 0
    for shape in SHAPES:
        cell, cell_t = SHAPES[shape], SHAPES_T[shape]
        if cell.step != "decode":
            continue
        for mode in modes:
            cs = steps_ref.cache_struct(cfg, cell,
                                        steps_ref.StepOptions(kv_mode=mode))
            cache = steps.cache_struct(cfg_t, cell_t,
                                       steps.StepOptions(kv_mode=mode))
            ours = _restacked(cache, cfg_t)
            for m in MESHES:
                ref_mesh, mesh = RefMesh(m), mesh_t.StandInMesh(m)
                opts = steps.pick_options(cfg_t, mesh, cell_t, kv_mode=mode)
                want = _ref_cache_specs(cs, _ref_rules(
                    cfg, ref_mesh, steps_ref.pick_options(
                        cfg, ref_mesh, cell, kv_mode=mode)))
                rules = steps.step_rules(cfg_t, mesh, opts)
                assert _port_specs_by_key(_meta_of(cs), rules) == want
                got = _port_specs_by_key(ours, rules)
                assert got == {k: v for k, v in want.items()
                               if k in got}, (shape, mode, m)
                assert got, (shape, mode)
                checked += 1
    assert checked


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-v3-671b"])
def test_lower_step_info_matches_reference(arch):
    """``lower_step``'s info on a 16 x 16 stand-in for a train and a
    decode cell: the reference's options, parameter counts and keys."""
    cfg, cfg_t = configs.get_config(arch), configs_t.get_config(arch)
    m = MESHES[0]
    for shape in ("train_4k", "decode_32k"):
        _, info = steps.lower_step(cfg_t, mesh_t.StandInMesh(m),
                                   SHAPES_T[shape])
        want = steps_ref.pick_options(cfg, RefMesh(m), SHAPES[shape])
        assert info["options"] == dataclasses.asdict(want)
        assert info["params"] == steps_ref.param_count(cfg)
        assert info["active_params"] == steps_ref.active_param_count(cfg)
        assert ("cache_bytes" in info) == (shape != "train_4k")
