"""Elastic checkpoints and the Trainer on a mesh (``checkpoint.ckpt``'s
``restore(specs=, rules=)`` and ``save_gathered``, ``runtime.trainer``
with a ``lower_step`` step), in gloo worlds of 8 ranks, on the reduced
qwen3-4b in f32 from the reference's weights:

* the twin of tests/test_distributed.py::test_elastic_restore_onto_
  sharded_mesh: a one-device checkpoint restored onto a (data=2,
  model=4) world gives every rank, for every parameter and moment leaf,
  exactly its block of the reference's ``ckpt.restore(shardings=)``
  shard on a 2 x 4 mesh of 8 fake XLA devices;
* a checkpoint saved from a 2 x 4 world (each leaf gathered, rank 0
  writing) is byte for byte the one-device save of the same state, and
  restores on one device in both packages;
* a Trainer on 2 x 4 that crashes at step 5 resumes on (data=8, model=1)
  from its step-4 checkpoint, and its losses equal the uninterrupted
  one-device run's within 1e-5 (relative);
* one rank sleeping in two steps makes every rank flag the same
  straggler steps, those two among them.
"""

import pickle

import jax
import numpy as np

import _torch_train_ckpt_ranks as cr
import _torch_train_mesh as tm
import _torch_train_ranks as ranks
import _torch_world
from _subproc import run_sub
from repro import configs as configs_ref
from repro.checkpoint import ckpt as ckpt_ref
from repro.models import transformer as tfm_ref
from repro.optim import adamw as adamw_ref
from repro_torch import bridge
from repro_torch.checkpoint import ckpt
from repro_torch.data import pipeline
from repro_torch.launch import steps
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def _state():
    """The one-device port's state after 2 steps from the reference's
    weights (moments non-zero): (cfg, params, OptState)."""
    cfg = cr._cfg()
    p = bridge.params_from_numpy(tm.weights("qwen3"), cfg, "cpu")
    o = adamw.init(p)
    step = steps.make_train_step(cfg, adamw.AdamWConfig(**cr.TRAINER_AW))
    data = pipeline.SyntheticLM(cfg, pipeline.DataConfig(
        seed=0, global_batch=cr.TRAINER_BATCH, seq_len=cr.TRAINER_SEQ))
    for s in range(2):
        p, o, _ = step(p, o, data.batch_at(s))
    return cfg, p, o


def _save_one_device(path, cfg, p, o, step):
    ckpt.save(str(path), step, {"params": bridge.params_to_host(p, cfg),
                                "opt": bridge.opt_state_to_host(o, cfg)})


REF_RESTORE = """
import dataclasses, functools, pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.checkpoint import ckpt
from repro.launch.mesh import _mesh
from repro.models import transformer as tfm
from repro.optim import adamw
from repro.sharding import rules as R

assert len(jax.devices()) == 8
cfg = dataclasses.replace(configs.get_reduced("qwen3-4b"), dtype="float32")
mesh = _mesh((2, 4), ("data", "model"))
rules = R.Rules(mesh, R.default_table(False))
pshapes = jax.eval_shape(functools.partial(tfm.init_params, cfg=cfg),
                         jax.random.PRNGKey(0))
like = {{"params": pshapes, "opt": jax.eval_shape(adamw.init, pshapes)}}
ns = lambda s: NamedSharding(mesh, s)
ps = jax.tree.map(ns, R.tree_param_specs(pshapes, rules),
                  is_leaf=lambda s: isinstance(s, P))
tree, step = ckpt.restore({ckdir!r}, like, shardings={{
    "params": ps, "opt": adamw.OptState(ps, ps, ns(P()))}})
out = {{}}
for kp, arr in jax.tree_util.tree_flatten_with_path(tree)[0]:
    key = "/".join(ckpt._k(k) for k in kp)
    for sh in arr.addressable_shards:
        i, j = np.argwhere(mesh.devices == sh.device)[0]
        out.setdefault(key, {{}})[int(i) * 4 + int(j)] = np.asarray(sh.data)
with open({out!r}, "wb") as f:
    pickle.dump((step, out), f)
"""


def test_elastic_restore_onto_2x4_world(tmp_path):
    cfg, p, o = _state()
    _save_one_device(tmp_path / "ck", cfg, p, o, 5)
    world = _torch_world.World("_torch_train_ckpt_ranks:restore_main", 8,
                               ckpt_dir=str(tmp_path / "ck"),
                               shape=ranks.MESH)
    out = tmp_path / "ref.pkl"
    run_sub(REF_RESTORE.format(ckdir=str(tmp_path / "ck"), out=str(out)))
    got = world.result()
    with open(out, "rb") as f:
        ref_step, ref = pickle.load(f)
    assert ref_step == 5 and all(g[0] == 5 for g in got)
    assert set(got[0][1]) == set(ref)
    for key, shards in ref.items():
        for rank in range(8):
            np.testing.assert_array_equal(got[rank][1][key], shards[rank],
                                          err_msg=f"rank {rank} {key}")
    # the model axis cuts most leaves: a rank holds a quarter of them
    flat = cr._flat(ckpt.restore(str(tmp_path / "ck"), cr._like(cfg))[0])
    assert sum(got[0][1][k].size * 4 == flat[k].size for k in flat) >= 10


def test_2x4_save_is_the_one_device_save(tmp_path):
    cfg, p, o = _state()
    _save_one_device(tmp_path / "one", cfg, p, o, 3)
    moments = tuple(bridge.opt_state_to_numpy(o, cfg))
    _torch_world.run_world("_torch_train_ckpt_ranks:save_main", 8,
                           ckpt_dir=str(tmp_path / "mesh"), shape=ranks.MESH,
                           weights=bridge.params_to_numpy(p, cfg),
                           moments=moments)
    for name in ("arrays.npz", "meta.json", "DONE"):
        a = (tmp_path / "one" / "step_00000003" / name).read_bytes()
        b = (tmp_path / "mesh" / "step_00000003" / name).read_bytes()
        assert a == b, name
    assert ckpt.latest_step(str(tmp_path / "mesh")) == 3
    like = cr._like(cfg)
    tree, step = ckpt.restore(str(tmp_path / "mesh"), like)
    want = {"params": bridge.params_to_host(p, cfg),
            "opt": bridge.opt_state_to_host(o, cfg)}
    flat_w = {k: (v() if callable(v) else v).numpy()
              for k, v in ((("/".join(path)), leaf)
                           for path, leaf in ckpt._items(want))}
    for k, v in cr._flat(tree).items():
        np.testing.assert_array_equal(v, flat_w[k], err_msg=k)
    cfg_ref = ranks.config("qwen3", configs_ref.get_reduced)
    pshapes = jax.eval_shape(lambda: tfm_ref.init_params(
        jax.random.PRNGKey(0), cfg_ref))
    ref_like = jax.tree.map(np.asarray, ckpt_ref.restore(
        str(tmp_path / "mesh"), {"params": pshapes, "opt": jax.eval_shape(
            adamw_ref.init, pshapes)})[0])
    for kp, a in jax.tree_util.tree_flatten_with_path(ref_like)[0]:
        key = "/".join(ckpt_ref._k(k) for k in kp)
        np.testing.assert_array_equal(a, flat_w[key], err_msg=key)


def test_trainer_crash_on_2x4_resumes_on_8x1(tmp_path):
    w = tm.weights("qwen3")
    crashed = _torch_world.run_world(
        "_torch_train_ckpt_ranks:trainer_main", 8, ckpt_dir=str(tmp_path),
        shape=ranks.MESH, n_steps=8, weights=w, fail_at=5)
    assert all(r[2] for r in crashed) and ckpt.latest_step(
        str(tmp_path)) == 4
    resumed = _torch_world.run_world(
        "_torch_train_ckpt_ranks:trainer_main", 8, ckpt_dir=str(tmp_path),
        shape={"data": 8, "model": 1}, n_steps=8, weights=w)
    assert not any(r[2] for r in resumed)
    assert all(r[0] == resumed[0][0] for r in resumed)
    assert ckpt.latest_step(str(tmp_path)) == 8

    cfg = cr._cfg()
    aw = adamw.AdamWConfig(**cr.TRAINER_AW)
    tr = Trainer(cfg, TrainerConfig(n_steps=8, ckpt_dir=str(tmp_path / "one"),
                                    ckpt_every=1000, log_every=1000), aw,
                 steps.make_train_step(cfg, aw), pipeline.SyntheticLM(
                     cfg, pipeline.DataConfig(seed=0,
                                              global_batch=cr.TRAINER_BATCH,
                                              seq_len=cr.TRAINER_SEQ)),
                 init_params_fn=lambda: bridge.params_from_numpy(
                     w, cfg, "cpu"), device="cpu")
    tr.run()
    np.testing.assert_allclose(crashed[0][0], tr.losses[:5], rtol=1e-5)
    np.testing.assert_allclose(resumed[0][0], tr.losses[4:], rtol=1e-5)
    np.testing.assert_allclose(resumed[0][1], tr.grad_norms[4:], rtol=1e-5)


def test_straggler_verdict_is_the_worlds(tmp_path):
    got = _torch_world.run_world("_torch_train_ckpt_ranks:straggler_main",
                                 8, ckpt_dir=str(tmp_path),
                                 weights=tm.weights("qwen3"))
    flagged = got[0][0]
    assert all(r[0] == flagged for r in got)
    assert all(r[1] == got[0][1] for r in got)
    assert set(cr.STRAGGLER_AT) <= set(flagged), flagged

