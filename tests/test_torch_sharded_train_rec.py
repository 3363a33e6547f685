"""Training on a mesh, the recurrent families and microbatches: the
reduced mamba2-2.7b ('M') and recurrentgemma-9b ('RRL'), and the reduced
gemma2-27b with 2 microbatches (a rank's shard of each of the
reference's ``_accum_grads`` slices, the gradients summed in f32), on a
(data=2, model=4) gloo world against the reference's own 2 x 4
``lower_step`` steps on 8 fake XLA devices and the port's one-device
step, 3 steps each at tests/_torch_train_mesh.py's tolerances (see
tests/test_torch_sharded_train.py)."""

import pytest

import _torch_train_mesh as tm

CASES = ("mamba2", "rgemma", "micro2")


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
    assert all(r[name]["losses"] == got[0][name]["losses"] for r in got)
    assert tm.problems(got[0][name], tm.single_device(name)) == []
