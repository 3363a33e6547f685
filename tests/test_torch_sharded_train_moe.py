"""Training on a mesh, the MoE families: the reduced deepseek-v3-671b
(MLA, 8 routed experts under ``impl="a2a"``, which on a (data=2, model=4)
mesh is the reference's all-to-all geometry: each data shard's rows in 4
chunks, each chunk's own capacity; MTP depth 1, whose loss keeps its own
label count) and qwen2-moe-a2.7b (``impl="sharded"``: each data shard's
own capacity buffers), each also with its routers skewed so that experts
run over capacity (tokens dropped in the data shards' buffers), on a gloo
world against the reference's own 2 x 4 ``lower_step`` steps on 8 fake
XLA devices and the port's one-device step.  The aux loss reads the global
expert load and mean router probabilities.  3 steps each at
tests/_torch_train_mesh.py's tolerances."""

import pytest

import _torch_train_mesh as tm

CASES = ("dsv3", "qwen2moe", "skew", "dsv3_skew")


@pytest.fixture(scope="module")
def runs():
    return tm.run(CASES)


@pytest.mark.parametrize("name", CASES)
def test_mesh_step_matches_reference(runs, name):
    got, ref = runs
    assert got[0][name]["options"] == ref[name]["options"]
    assert tm.problems(got[0][name], ref[name]) == []
    assert got[0][name]["metrics"]["aux_loss"] > 0


@pytest.mark.parametrize("name", CASES)
def test_mesh_step_matches_single_device(runs, name):
    got, _ = runs
    assert all(r[name]["losses"] == got[0][name]["losses"] for r in got)
    assert tm.problems(got[0][name], tm.single_device(name)) == []


@pytest.mark.parametrize("name,plain", [("skew", "qwen2moe"),
                                        ("dsv3_skew", "dsv3")])
def test_skewed_routers_drop_tokens(runs, name, plain):
    """The skewed cases run experts over capacity: they drop more tokens
    than the unskewed ones, over 5 % of them in some layer."""
    got, _ = runs
    assert got[0][name]["drop"] > max(0.05, got[0][plain]["drop"])
