"""Training on a (pod=2, data=2, model=2) gloo world with the k-means
gradient compression of ``--grad-compress`` on ``axis_name="pod"``: the
reduced qwen3-4b's rows split over ("pod", "data"), its gradient summed
over both and compressed a whole leaf at a time (a scan-stacked leaf of
the reference's as one, ``bridge.stack_groups``), against the reference's
own (2, 2, 2) ``lower_step`` steps on 8 fake XLA devices and the port's
one-device step, 3 steps at tests/_torch_train_mesh.py's tolerances."""

import pytest

import _torch_train_mesh as tm


@pytest.fixture(scope="module")
def runs():
    return tm.run(("pod_gc",))


def test_pod_mesh_step_with_compression_matches_reference(runs):
    got, ref = runs
    assert got[0]["pod_gc"]["rows"] == ("pod", "data")
    assert got[0]["pod_gc"]["options"] == ref["pod_gc"]["options"]
    assert tm.problems(got[0]["pod_gc"], ref["pod_gc"]) == []


def test_pod_mesh_step_with_compression_matches_single_device(runs):
    got, _ = runs
    assert all(r["pod_gc"]["losses"] == got[0]["pod_gc"]["losses"]
               for r in got)
    assert tm.problems(got[0]["pod_gc"], tm.single_device("pod_gc")) == []
