"""Shared pieces of the training-on-a-mesh parity tests
(tests/test_torch_sharded_train*.py).

:func:`run` starts the port's 8-rank gloo world on the cases
(``_torch_train_ranks``) and, beside it, the reference's own mesh steps in
a child process with 8 fake XLA devices (``_ref_mesh_runs.py train``),
both from the reference's ``init_params`` (seed 0, the router skewed where
a case says); :func:`single_device` runs the port's one-device
``make_train_step`` on the same weights and batches.  :func:`problems`
compares two runs.

Tolerances (the reference's mesh steps differ from its own single-device
step by 1e-7 relative on these cases):

* each step's loss and gradient norm within ``LOSS_RTOL`` = 1e-5,
  relative;
* every element of both AdamW moments within ``LEAF_TOL`` = 1e-4 of its
  leaf's largest entry;
* every parameter element within ``LEAF_TOL`` of its leaf's largest
  entry, but for at most ``OFF_FRAC`` = 1e-3 of a leaf's elements, each
  within ``OFF_LR`` = 0.1 of the learning rate: AdamW divides each
  gradient element by its own magnitude (plus eps 1e-8), so an element
  whose gradient is a few eps carries the gradient's rounding difference
  into its update at full scale.  Seen: at most 2 elements of a leaf
  (gemma2-27b's 65,536-element MLP leaves), 0.023 lr at most.
"""

import pickle
import tempfile

import jax
import numpy as np

import _ref_mesh_runs
import _torch_train_ranks as ranks
import _torch_world
from _torch_ref import ref_init_params
from repro import configs

LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4
OFF_FRAC, OFF_LR = 1e-3, 0.1


def weights(name: str):
    """The case's starting parameters: the reference's (numpy), its
    routers skewed where the case says."""
    cfg = ranks.config(name, configs.get_reduced)
    p = jax.tree.map(np.asarray, ref_init_params(cfg))
    return ranks.skew_router(p) if ranks.case(name)["skew"] else p


def run(cases, plant=None):
    """(each rank's results, the reference's results) of ``cases``: the
    port's world and the reference's child run at once."""
    w = {n: weights(n) for n in cases}
    with tempfile.NamedTemporaryFile(suffix=".pkl") as f:
        proc = _ref_mesh_runs.start("train", f.name, *cases)
        world = _torch_world.World("_torch_train_ranks:train_main", 8,
                                   cases=list(cases), weights=w, plant=plant)
        try:
            got = world.result()
        finally:
            _ref_mesh_runs.result(proc, timeout=600)
        with open(f.name, "rb") as fh:
            ref = pickle.load(fh)
    return got, ref


def run_world(cases, plant=None):
    """Each rank's results of ``cases`` alone (no reference child)."""
    w = {n: weights(n) for n in cases}
    return _torch_world.run_world("_torch_train_ranks:train_main", 8,
                                  cases=list(cases), weights=w, plant=plant)


def single_device(name: str):
    """The port's one-device ``make_train_step`` on the case (the options
    the case's mesh picks): (losses, norms, [params, m, v] in the
    reference's layout).  A MoE model's steps run under the mesh's
    training rules with every row on the one device (``train_rows=()``):
    its dispatch then cuts the rows into the mesh's data shards, as the
    reference's does on a mesh, with no collective."""
    import contextlib
    import dataclasses

    from repro_torch import bridge
    from repro_torch.sharding import rules as shard_rules
    from repro_torch import configs as configs_t
    from repro_torch.core import grad_compress
    from repro_torch.data import pipeline
    from repro_torch.launch import mesh, steps
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import adamw

    c = ranks.case(name)
    cfg = ranks.config(name, configs_t.get_reduced)
    cell = ShapeCell("t", ranks.SEQ, c["batch"], "train")
    opts = steps.pick_options(cfg, mesh.StandInMesh(c["mesh"]), cell,
                              **c["overrides"])
    gt = (grad_compress.make_grad_transform(grad_compress.CompressConfig())
          if c["grad_compress"] else None)
    step = steps.make_train_step(cfg, adamw.AdamWConfig(**ranks.AW), opts,
                                 gt)
    p = bridge.params_from_numpy(weights(name), cfg, "cpu")
    o = adamw.init(p)
    data = pipeline.SyntheticLM(cfg, pipeline.DataConfig(
        seed=0, global_batch=c["batch"], seq_len=ranks.SEQ))
    rules = dataclasses.replace(steps.step_rules(
        cfg, mesh.StandInMesh(c["mesh"]), opts), train_rows=())
    losses, norms = [], []
    for s in range(ranks.STEPS):
        with (shard_rules.use_rules(rules) if cfg.moe is not None
              else contextlib.nullcontext()):
            p, o, m = step(p, o, data.batch_at(s))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms,
            "tree": [bridge.params_to_numpy(t, cfg) for t in (p, o.m, o.v)]}


def problems(got: dict, want: dict) -> list:
    """Where run ``got`` differs from ``want`` beyond the tolerances (the
    module docstring): a list of findings, empty when they agree."""
    out = []
    for key in ("losses", "norms"):
        g, w = np.asarray(got[key]), np.asarray(want[key])
        rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-30)
        if not rel.max() <= LOSS_RTOL:
            out.append(f"{key}: {g.tolist()} vs {w.tolist()}")
    lr = ranks.AW["lr"]
    for which, gt, wt in zip(("params", "m", "v"), got["tree"],
                             want["tree"]):
        wf = dict(jax.tree_util.tree_flatten_with_path(wt)[0])
        gf = jax.tree_util.tree_flatten_with_path(gt)[0]
        if len(gf) != len(wf):
            out.append(f"{which}: {len(gf)} leaves, want {len(wf)}")
            continue
        for kp, g in gf:
            w = np.asarray(wf[kp], np.float32)
            g = np.asarray(g, np.float32)
            name = f"{which}{jax.tree_util.keystr(kp)}"
            if g.shape != w.shape:
                out.append(f"{name}: shape {g.shape}, want {w.shape}")
                continue
            d = np.abs(g - w)
            off = d > LEAF_TOL * max(float(np.abs(w).max()), 1e-30)
            if which != "params" and off.any():
                out.append(f"{name}: max err {d.max():.3g}")
            elif off.sum() > OFF_FRAC * d.size or (
                    off.any() and d[off].max() > OFF_LR * lr):
                out.append(f"{name}: {int(off.sum())} of {d.size} off, "
                           f"max {d.max():.3g}")
    return out
