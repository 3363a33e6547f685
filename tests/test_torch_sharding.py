"""The port's sharding rules (``repro_torch.sharding``), meshes and rank
bring-up (``repro_torch.launch.mesh`` / ``preboot``) against the
reference's, in process (no world needed):

* the twins of tests/test_sharded_serving.py's spec pins
  (``test_serving_param_specs_single_device``,
  ``test_cache_partition_specs_single_device``,
  ``test_indivisible_dims_replicate_in_specs``), and ``param_spec``,
  ``cache_spec``, ``admission_spec``, ``block_table_spec`` and
  ``axes_for`` equal to the reference's over a grid of leaf paths, shapes
  and fake mesh shapes, single- and multi-pod, with and without fsdp;
* ``kernels.ops._kernel_shard_axes`` equal to the reference's;
* "take this rank's block": every rank's blocks of a cache, an admission
  cache and a block table put back together give the whole, with block
  ids rebased to the rank's pool;
* ``parse_mesh_spec``'s errors are the reference's; a mesh asked for
  without a world raises naming the ranks it needs; a CUDA ``--mesh``
  larger than the visible card count is refused.
"""

import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.kernels import ops as ops_ref
from repro.launch import mesh as mesh_ref
from repro.sharding import rules as rules_ref
from repro_torch.kernels import ops as ops_t
from repro_torch.launch import mesh as mesh_t
from repro_torch.launch import preboot
from repro_torch.sharding import rules as rules_t

import _torch_ref  # noqa: F401  (one torch thread, the JAX cache)


class FakeMesh:
    """A mesh shape without devices; with ``coord`` (axis -> index) it
    also stands for one rank's ``DeviceMesh``."""

    def __init__(self, shape: dict, coord=None):
        self.shape = dict(shape)
        self.axis_names = self.mesh_dim_names = tuple(shape)
        self._coord = coord or {a: 0 for a in shape}

    def get_coordinate(self):
        return [self._coord[a] for a in self.mesh_dim_names]


MESHES = [{"data": 2, "model": 4}, {"data": 1, "model": 1},
          {"data": 4, "model": 2}, {"pod": 2, "data": 2, "model": 2}]


def _rules(shape, fsdp=False):
    multi = "pod" in shape
    return (rules_ref.Rules(FakeMesh(shape), rules_ref.default_table(multi),
                            fsdp=fsdp),
            rules_t.Rules(FakeMesh(shape), rules_t.default_table(multi),
                          fsdp=fsdp))


def _spec(p):
    """A reference PartitionSpec as the port's tuple (JAX shows a one-axis
    entry as the bare name)."""
    return tuple((e,) if isinstance(e, str) else e for e in p)


PARAM_LEAVES = [
    ("tail/0/moe/w_gate", (8, 64, 96)), ("tail/0/moe/w_down", (60, 96, 64)),
    ("scan/sub0/moe/w_up", (2, 8, 64, 96)), ("tail/0/moe/router", (64, 8)),
    ("tail/0/moe/bias", (8,)), ("embed/table", (512, 64)),
    ("embed/head", (64, 512)), ("embed/head", (64, 510)),
    ("layers/0/attn/wq", (64, 64)), ("layers/0/attn/wk", (64, 32)),
    ("layers/0/attn/wo", (64, 64)), ("layers/0/attn/wdkv", (64, 24)),
    ("layers/0/mlp/w_gate", (64, 128)), ("layers/0/mlp/w_down", (128, 64)),
    ("layers/0/mlp/w_up", (64, 130)), ("layers/0/rg/wx", (64, 64)),
    ("layers/0/rg/rg_out", (64, 64)), ("layers/0/ssm/in_proj", (64, 258)),
    ("layers/0/ssm/out_proj", (128, 64)), ("frontend/proj", (48, 64)),
    ("layers/0/norm1/scale", (64,)), ("layers/0/ssm/A_log", (8,)),
]

CACHE_LEAVES = [
    ("tail/0/k", (4, 64, 2, 16)), ("scan/sub0/k_cents", (2, 4, 8, 2, 16)),
    ("scan/sub0/counts", (2, 4, 8, 2)), ("tail/0/cov", (4,)),
    ("tail/0/k_scale", (2,)), ("tail/0/k_tail", (8, 4, 2, 16)),
    ("scan/sub0/v_tail", (2, 8, 4, 2, 16)), ("tail/1/k", (4, 16, 2, 16)),
    ("tail/0/ckv", (4, 64, 8)), ("scan/sub0/ssm", (2, 4, 2, 16, 16)),
    ("layers/0/k", (3, 64, 8, 16)), ("layers/0/v_cents", (4, 8, 8, 16)),
    ("layers/0/counts", (6, 8, 4)), ("layers/0/k_tail", (12, 4, 4, 16)),
]


def test_serving_param_specs_single_device():
    """The twin of the reference's pin: expert banks take the model axis
    (spilling to data when the count divides, model alone for 60),
    leading stacked dims unsharded, every other leaf replicated."""
    params = {
        "tail": [{"moe": {
            "w_gate": np.zeros((8, 64, 96)),
            "w_down": np.zeros((60, 96, 64)),
            "router": np.zeros((64, 8)),
            "shared": {"w_gate": np.zeros((64, 128))},
        }, "wq": np.zeros((64, 64))}],
        "scan": {"moe": {"w_up": np.zeros((2, 8, 64, 96))}},
    }
    ref, port = _rules({"data": 2, "model": 4})
    specs = rules_t.serving_param_specs(params, port)
    want = rules_ref.serving_param_specs(params, ref)
    t = specs["tail"][0]
    assert t["moe"]["w_gate"] == (("model", "data"), None, None)
    assert t["moe"]["w_down"] == (("model",), None, None)
    assert specs["scan"]["moe"]["w_up"] == (None, ("model", "data"), None,
                                            None)
    assert t["moe"]["router"] == t["moe"]["shared"]["w_gate"] == t["wq"] == ()
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    assert [_spec(x) for x in jax.tree.leaves(want, is_leaf=is_spec)] == \
        jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, tuple))


def test_cache_partition_specs_single_device():
    """The twin of the reference's pin on a (1, 1) mesh: slots over data,
    kv heads over model, stacked leaves shift by the layer dim."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    ref = rules_ref.Rules(mesh, rules_ref.default_table(False))
    port = rules_t.Rules(FakeMesh({"data": 1, "model": 1}),
                         rules_t.default_table(False))
    assert rules_t.cache_spec("tail/0/k", (4, 64, 2, 16), port) == \
        (("data",), None, ("model",), None)
    assert rules_t.block_table_spec((4, 4), port) == (("data",), None)
    for path, shape in CACHE_LEAVES:
        assert rules_t.cache_spec(path, shape, port) == \
            _spec(rules_ref.cache_spec(path, shape, ref)), path


def test_indivisible_dims_replicate_in_specs():
    ref, port = _rules({"data": 2, "model": 4})
    assert rules_t.cache_spec("tail/0/k", (3, 64, 2, 16), port) == \
        (None, None, None, None)
    assert rules_t.cache_spec("tail/0/k", (4, 64, 8, 16), port) == \
        (("data",), None, ("model",), None)
    for path, shape in CACHE_LEAVES:
        assert rules_t.cache_spec(path, shape, port) == \
            _spec(rules_ref.cache_spec(path, shape, ref)), path


@pytest.mark.parametrize("shape", MESHES,
                         ids=["2x4", "1x1", "4x2", "pod2x2x2"])
@pytest.mark.parametrize("fsdp", [False, True], ids=["replicated", "fsdp"])
def test_specs_equal_reference(shape, fsdp):
    ref, port = _rules(shape, fsdp)
    for path, shp in PARAM_LEAVES:
        assert rules_t.param_spec(path, shp, port) == \
            _spec(rules_ref.param_spec(path, shp, ref)), path
    for path, shp in CACHE_LEAVES:
        assert rules_t.cache_spec(path, shp, port) == \
            _spec(rules_ref.cache_spec(path, shp, ref)), path
        assert rules_t.admission_spec(path, shp, port) == \
            _spec(rules_ref.admission_spec(path, shp, ref)), path
    for rows in (1, 2, 3, 4, 6, 8):
        assert rules_t.block_table_spec((rows, 4), port) == \
            _spec(rules_ref.block_table_spec((rows, 4), ref))
    for logical in rules_t.default_table("pod" in shape):
        for dim in (1, 2, 3, 4, 6, 8, 60, 64):
            assert port.axes_for(logical, dim) == ref.axes_for(logical, dim)
    params = {"layers": [{"attn": {"wq": np.zeros((64, 64))},
                          "mlp": {"w_down": np.zeros((128, 64))}}]}
    assert jax.tree.leaves(rules_t.tree_param_specs(params, port),
                           is_leaf=lambda s: isinstance(s, tuple)) == \
        [_spec(s) for s in jax.tree.leaves(
            rules_ref.tree_param_specs(params, ref),
            is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))]


def test_kernel_shard_axes_equal_reference():
    for shape in MESHES:
        ref, port = _rules(shape)
        for b, hq, hkv in itertools.product((1, 2, 3, 4, 8), (4, 8, 32, 64),
                                            (1, 2, 4, 8)):
            if hq % hkv:
                continue
            assert ops_t._kernel_shard_axes(port, b, hq, hkv) == \
                ops_ref._kernel_shard_axes(ref, b, hq, hkv), (shape, b, hq,
                                                               hkv)


def _blocks(shape, fn):
    """fn(rules) for every rank of a fake (data, model) mesh, by
    coordinate."""
    out = {}
    for d in range(shape["data"]):
        for m in range(shape["model"]):
            rules = rules_t.Rules(FakeMesh(shape, {"data": d, "model": m}),
                                  rules_t.default_table(False))
            out[d, m] = fn(rules)
    return out


def test_rank_blocks_are_the_reference_partition():
    """shard_cache: rank (d, m) of a 2x4 mesh holds slot block d and
    kv-head block m of each leaf (a paged pool's block axis splits like
    the slots; 2 kv heads do not divide 4 and replicate);
    place_admission, place_swap_payload and place_prefix_snapshot: head
    block m at every position; place_block_tables: slot block d of the
    table, ids rebased to the rank's pool."""
    shape = {"data": 2, "model": 4}
    gen = torch.Generator().manual_seed(0)
    cache = {"layers": [
        {"k_cents": torch.randn(4, 8, 8, 16, generator=gen),
         "counts": torch.rand(4, 8, 8, generator=gen),
         "k_tail": torch.randn(12, 4, 8, 16, generator=gen),
         "cov": torch.arange(4, dtype=torch.int32)},
        {"k": torch.randn(4, 64, 2, 16, generator=gen)}]}
    adm = {"layers": [{"k": torch.randn(1, 32, 8, 16, generator=gen)}]}
    swap = {"layers": [{"k_tail": torch.randn(3, 4, 8, 16, generator=gen)}]}
    bt = np.array([[0, 1], [2, 0], [6, 5], [4, 4]], np.int32)  # 4 blocks/shard
    for (d, m), got in _blocks(shape, lambda r: (
            rules_t.shard_cache(cache, r), rules_t.place_admission(adm, r),
            rules_t.place_block_tables(bt, r, 4),
            rules_t.place_swap_payload(swap, r),
            rules_t.place_prefix_snapshot(cache, r))).items():
        c, a, b, sw, snap = got
        sl, hd = slice(2 * d, 2 * d + 2), slice(2 * m, 2 * m + 2)
        whole = cache["layers"]
        assert torch.equal(c["layers"][0]["k_cents"],
                           whole[0]["k_cents"][sl, :, hd])
        assert torch.equal(c["layers"][0]["counts"],
                           whole[0]["counts"][sl, :, hd])
        assert torch.equal(c["layers"][0]["k_tail"],
                           whole[0]["k_tail"][6 * d:6 * d + 6, :, hd])
        assert torch.equal(c["layers"][0]["cov"], whole[0]["cov"][sl])
        assert torch.equal(c["layers"][1]["k"], whole[1]["k"][sl])
        assert torch.equal(a["layers"][0]["k"], adm["layers"][0]["k"][:, :, hd])
        np.testing.assert_array_equal(b, bt[sl] - 4 * d)
        # a swap payload's and a snapshot's leading axis is no slot axis:
        # only their heads split
        assert torch.equal(sw["layers"][0]["k_tail"],
                           swap["layers"][0]["k_tail"][:, :, hd])
        assert torch.equal(snap["layers"][0]["k_cents"],
                           whole[0]["k_cents"][:, :, hd])
        assert torch.equal(snap["layers"][0]["cov"], whole[0]["cov"])


@pytest.mark.parametrize("shape,n_routed,per_rank", [
    ({"data": 2, "model": 4}, 8, 1),      # ("model", "data"): 1 a rank
    ({"data": 2, "model": 2}, 60, 15),    # qwen2-moe's 60 on 2 x 2
    ({"data": 2, "model": 4}, 60, 15),    # 60 % 8: ("model",) alone
    ({"data": 2, "model": 4}, 6, 6),      # nothing divides: replicated
])
def test_serving_params_place_expert_blocks(shape, n_routed, per_rank):
    """place_serving_params: rank (d, m) holds its block of every routed
    bank, folded over ``expert_axes`` in their order (model-major), and
    every other leaf whole (the same tensor); the blocks of all ranks put
    back together give the whole bank."""
    gen = torch.Generator().manual_seed(1)
    params = {"layers": [{"moe": {
        "w_gate": torch.randn(n_routed, 8, 6, generator=gen),
        "w_down": torch.randn(n_routed, 6, 8, generator=gen),
        "router": torch.randn(8, n_routed, generator=gen),
        "bias": torch.zeros(n_routed),
        "shared": {"w_gate": torch.randn(8, 12, generator=gen)}},
        "attn": {"wq": torch.randn(8, 8, generator=gen)}}]}
    blocks = {}
    for (d, m), got in _blocks(shape, lambda r: (
            rules_t.place_serving_params(params, r),
            rules_t.expert_axes(r, n_routed))).items():
        placed, axes = got
        p, whole = placed["layers"][0], params["layers"][0]
        assert p["moe"]["w_gate"].shape[0] == per_rank
        coord = {"data": d, "model": m}
        idx = 0
        for a in axes or ():
            idx = idx * shape[a] + coord[a]
        for k in ("w_gate", "w_down"):
            assert torch.equal(p["moe"][k], whole["moe"][k][
                idx * per_rank:(idx + 1) * per_rank])
        blocks.setdefault(idx, p["moe"]["w_gate"])
        for leaf in (("moe", "router"), ("moe", "bias"), ("attn", "wq")):
            assert p[leaf[0]][leaf[1]] is whole[leaf[0]][leaf[1]]
        assert (p["moe"]["shared"]["w_gate"]
                is whole["moe"]["shared"]["w_gate"])
    assert torch.equal(torch.cat([blocks[i] for i in sorted(blocks)]),
                       params["layers"][0]["moe"]["w_gate"])


def test_row_shards_follow_the_table():
    """row_shards: the batch axes' size, 1 for whole rows or a replicated
    batch."""
    mesh = FakeMesh({"data": 2, "model": 4})
    rules = rules_t.Rules(mesh, rules_t.default_table(False))
    assert rules_t.row_shards(rules) == 2
    assert rules_t.row_shards(dataclasses.replace(rules,
                                                  whole_rows=True)) == 1
    table = dict(rules_t.default_table(False), batch=None)
    assert rules_t.row_shards(rules_t.Rules(mesh, table)) == 1


def test_mesh_spec_errors_equal_reference():
    for bad in ("2", "2x2x2", "0x4", "2x-1"):
        with pytest.raises(ValueError) as want:
            mesh_ref.parse_mesh_spec(bad)
        with pytest.raises(ValueError) as got:
            mesh_t.parse_mesh_spec(bad)
        assert str(got.value) == str(want.value)
    assert mesh_t.parse_mesh_spec("2X4") == mesh_ref.parse_mesh_spec("2X4")


def test_mesh_without_a_world_raises():
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="mesh 2x4 needs a torch.distributed"
                       " world of 8 ranks but none is initialised"):
        mesh_t.make_serving_mesh("2x4")
    with pytest.raises(ValueError, match="world of 256 ranks"):
        mesh_t.make_production_mesh()
    with pytest.raises(ValueError, match="world of 512 ranks"):
        mesh_t.make_production_mesh(multi_pod=True)


def test_preboot_reads_the_mesh_and_refuses_more_cuda_ranks_than_cards(
        capsys, monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert preboot.mesh_ranks(["--arch", "x", "--mesh", "2x4"]) == 8
    assert preboot.mesh_ranks(["--mesh=3x1"]) == 3
    assert preboot.mesh_ranks(["--mesh", "bad"]) is None
    assert preboot.mesh_ranks(["--arch", "x"]) is None
    # nothing to start: no --mesh, or already a rank
    assert preboot.start_mesh_ranks(["--arch", "x"], "m") is None
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "8")
    assert preboot.start_mesh_ranks(["--mesh", "2x4"], "m") is None
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    # more CUDA ranks than any host has cards: refused before any start
    cards = torch.cuda.device_count()
    assert preboot.start_mesh_ranks(["--mesh", "64x64", "--device", "cuda"],
                                    "m") == 2
    assert (f"m: error: --mesh: a CUDA mesh of 4096 ranks needs 4096 cards "
            f"(NCCL puts one rank on each) but {cards} are visible"
            in capsys.readouterr().err)
    with pytest.raises(ValueError, match="4096 cards"):
        preboot.check_cuda_world(4096)
    preboot.init_world("cpu")       # no world in the environment: nothing
    assert not torch.distributed.is_initialized()
