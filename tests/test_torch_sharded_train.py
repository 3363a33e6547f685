"""Training on a mesh (``launch.steps.lower_step``'s ``MeshTrainStep``,
``sharding.rules.place_train_state`` / ``GatherLeaf``) on a (data=2,
model=4) gloo world against the reference's own 2 x 4 ``lower_step``
steps on 8 fake XLA devices and against the port's one-device step: the
reduced qwen3-4b ('G', kv_repeat 2 on 4 model ranks) and gemma2-27b
('LG'), qwen3-4b with ``fsdp=True`` forced (every leaf also cut over
``data``), and a global batch of 3 rows, which does not divide ``data``
(every rank holds all rows and nothing is summed over them).  3 steps
each, in f32, at the tolerances of tests/_torch_train_mesh.py's
docstring: each step's loss and gradient norm, and every parameter and
moment leaf after step 3, each gathered from the ranks' blocks.  A
planted fault, one leaf's gradient summed over ``model`` too, must fail
the comparison.  The other families are in
tests/test_torch_sharded_train_rec.py and _moe.py, the (pod, data,
model) world with gradient compression in _pod.py.
"""

import math

import pytest

import _torch_train_mesh as tm
import _torch_train_ranks as ranks
from repro_torch import bridge
from repro_torch import configs as configs_t
from repro_torch.core import tree
from repro_torch.launch import mesh as mesh_t
from repro_torch.launch import steps
from repro_torch.models.config import ShapeCell
from repro_torch.optim import adamw
from repro_torch.sharding import rules as shard_rules

CASES = ("qwen3", "gemma2", "fsdp", "rows3")


@pytest.fixture(scope="module")
def runs():
    return tm.run(CASES)


@pytest.mark.parametrize("name", CASES)
def test_mesh_step_matches_reference(runs, name):
    got, ref = runs
    assert got[0][name]["options"] == ref[name]["options"]
    assert tm.problems(got[0][name], ref[name]) == []


@pytest.mark.parametrize("name", CASES)
def test_mesh_step_matches_single_device(runs, name):
    got, _ = runs
    assert tm.problems(got[0][name], tm.single_device(name)) == []


@pytest.mark.parametrize("name", CASES)
def test_every_rank_holds_its_block(runs, name):
    """Every rank reports the same losses and metrics, its rows are split
    over ``data`` (3 rows: not at all), and its blocks have the shapes
    its coordinate's ``place_train_state`` cuts (under ``fsdp`` the
    embedding table's 8 ways)."""
    got, _ = runs
    first = got[0][name]
    c = ranks.case(name)
    cfg = ranks.config(name, configs_t.get_reduced)
    cell = ShapeCell("t", ranks.SEQ, c["batch"], "train")
    whole = bridge.params_from_numpy(tm.weights(name), cfg, "meta")
    for rank, res in enumerate(got):
        r = res[name]
        assert (r["losses"], r["norms"], r["metrics"]) == (
            first["losses"], first["norms"], first["metrics"]), rank
        assert r["rows"] == (() if name == "rows3" else ("data",))
        mesh = mesh_t.StandInMesh(c["mesh"], {"data": rank // 4,
                                              "model": rank % 4})
        step, _ = steps.lower_step(cfg, mesh, cell, steps.pick_options(
            cfg, mesh, cell, **c["overrides"]))
        blocks, _ = shard_rules.place_train_state(whole, adamw.init(whole),
                                                  step.rules)
        assert r["blocks"] == [tuple(b.shape) for b in tree.leaves(blocks)]
    table = tree.leaves(whole).index(whole["embed"]["table"])
    cut = math.prod(tree.leaves(whole)[table].shape) // math.prod(
        first["blocks"][table])
    assert cut == (8 if name == "fsdp" else 4)


def test_planted_sum_over_model_is_caught(runs):
    """One leaf's gradient summed over ``model`` as well as over the rows
    (4 times too large, every model rank having computed the same
    contribution): the comparison with the reference must fail on it."""
    _, ref = runs
    got = tm.run_world(("qwen3",), plant="sum_over_model")
    found = tm.problems(got[0]["qwen3"], ref["qwen3"])
    assert any(f.startswith(("m[", "v[", "norms")) for f in found), found
