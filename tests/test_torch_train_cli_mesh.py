"""The training and dry-run CLIs on a mesh:

* ``launch.train --mesh host`` in a 2-rank gloo world trains the reduced
  qwen3-4b (bf16, its config's dtype) on the (2, 1) host mesh, rank 0
  alone printing the one-device run's line, its final loss within
  ``CLI_RTOL`` = 1e-3 of the one-device run's (bf16 products over 1 row
  and over 2 round apart; seen 8e-5);
* ``--mesh host`` with no world prints exactly the one-device line;
* ``--mesh pod`` in a one-rank world fails naming the 256 ranks the
  16 x 16 mesh needs;
* ``launch.dryrun --device meta --mesh pod`` (``both``) on the reduced
  qwen3-4b's ``train_4k`` cell writes ``__16x16`` (and ``__2x16x16``)
  records holding one rank's count, its collectives counted; a mesh cell
  on ``--device cuda`` is refused naming 256 cards;
* a (data=2, model=4) stand-in count of the reduced qwen3-4b's train cell
  (f32, the reference's master dtype) gives the argument bytes of the
  reference's compiled 2 x 4 step, per device.
"""

import dataclasses
import json
import re

import pytest

import _torch_train_ckpt_ranks as cr
import _torch_train_ranks as ranks
import _torch_world
from _subproc import run_sub
from repro_torch import configs
from repro_torch.launch import dryrun, steps, train
from repro_torch.launch import mesh as mesh_t
from repro_torch.models.config import SHAPES, ShapeCell

CLI_RTOL = 1e-3
LINE = re.compile(r"^\[train\] done: final loss [0-9.]+, stragglers "
                  r"flagged: \d+$")


def test_train_mesh_host_in_a_world_matches_one_device(tmp_path, capsys):
    got = _torch_world.run_world("_torch_train_ckpt_ranks:cli_main", 2,
                                 ckpt_dir=str(tmp_path / "mesh"))
    tr = train.main(cr.CLI_ARGS + ["--ckpt-dir", str(tmp_path / "one")])
    out = capsys.readouterr().out
    assert LINE.match(out.strip()) and out.count("\n") == 1, out
    assert got[0][1] == f"[train] done: final loss {got[0][0]:.4f}, " \
        "stragglers flagged: 0\n"
    assert got[1][1] == "" and got[0][0] == got[1][0]
    assert got[0][0] == pytest.approx(tr.losses[-1], rel=CLI_RTOL)


def test_train_mesh_pod_in_a_small_world_names_its_ranks(tmp_path):
    got = _torch_world.run_world("_torch_train_ckpt_ranks:cli_main", 1,
                                 ckpt_dir=str(tmp_path),
                                 argv=["--mesh", "pod"])
    loss, _, err, code = got[0]
    assert loss is None and code == 2
    assert "256 ranks" in err and "the world has 1" in err


def test_dryrun_mesh_counts_one_rank(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun.configs, "get_config", configs.get_reduced)
    dryrun.main(["--device", "meta", "--arch", "qwen3-4b", "--shape",
                 "train_4k", "--mesh", "both", "--out", str(tmp_path)])
    assert "all requested cells done" in capsys.readouterr().out
    for tag, n in (("16x16", 256), ("2x16x16", 512)):
        rec = json.loads((tmp_path / f"qwen3-4b__train_4k__{tag}.json")
                         .read_text())
        assert (rec["mesh"], rec["n_devices"]) == (tag, n)
        st = rec["op_stats"]
        assert st["collectives"]["all-gather"] > 0
        assert st["collectives"]["all-reduce"] > 0
        assert st["collective_calls"]["all-reduce"] >= 3
        mesh = mesh_t.StandInMesh(mesh_t.production_shape(n == 512))
        assert rec["info"]["options"] == dataclasses.asdict(
            steps.pick_options(configs.get_reduced("qwen3-4b"), mesh,
                               SHAPES["train_4k"]))
    with pytest.raises(SystemExit):
        dryrun.main(["--device", "cuda", "--mesh", "pod"])
    assert "256 cards" in capsys.readouterr().err


REF_ARGS = """
import dataclasses
from repro import configs
from repro.launch import steps
from repro.launch.mesh import _mesh
from repro.models.config import ShapeCell
cfg = dataclasses.replace(configs.get_reduced("qwen3-4b"), dtype="float32")
mesh = _mesh((2, 4), ("data", "model"))
lowered, _ = steps.lower_step(cfg, mesh, ShapeCell("t", {seq}, {batch},
                                                   "train"))
print("ARGS", lowered.compile().memory_analysis().argument_size_in_bytes)
"""


def test_mesh_argument_bytes_are_the_references():
    cfg = ranks.config("qwen3", configs.get_reduced)
    rec = dryrun.run_cell("qwen3-4b", "t", device="meta", cfg=cfg,
                          cell=ShapeCell("t", ranks.SEQ, ranks.BATCH,
                                         "train"), mesh=ranks.MESH)
    out = run_sub(REF_ARGS.format(seq=ranks.SEQ, batch=ranks.BATCH))
    want = int(out.split("ARGS")[1].split()[0])
    assert rec["memory_analysis"]["argument_bytes"] == want
    assert rec["mesh"] == "2x4" and rec["n_devices"] == 8
