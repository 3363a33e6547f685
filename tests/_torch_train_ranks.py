"""The ranks of the port's training-on-a-mesh tests
(tests/test_torch_sharded_train*.py), run through ``_torch_world``, and
the cases they share with the reference's child (``_ref_mesh_runs.py
train``); imports neither JAX nor the reference.

Every case is a reduced config in f32 trained for ``STEPS`` steps on
``SyntheticLM`` batches of ``BATCH`` x ``SEQ`` tokens at ``AW``, with the
options ``pick_options`` gives on the case's mesh (``overrides`` on top),
from the reference's ``init_params`` (seed 0) that the caller bridged
(numpy trees, the reference layout).  Each rank places its blocks
(``rules.place_train_state``), runs ``lower_step``'s step and returns
every step's loss and gradient norm; rank 0 also returns the parameters
and both moments after the last step, each leaf gathered from the ranks'
blocks, in the reference's layout.
"""

import dataclasses

import numpy as np
import torch

SEQ, BATCH, STEPS = 32, 4, 3
#: no warmup, so each step moves the parameters by about lr
AW = dict(lr=1e-3, warmup_steps=0)
#: the router column that the skewed cases scale, and by how much: about
#: half the tokens then pick expert 0, past its capacity
SKEW = 40.0

CASES = {
    # the six families on (data=2, model=4); qwen3 and gemma2 take
    # kv_repeat 2 there
    "qwen3": dict(arch="qwen3-4b"),
    "gemma2": dict(arch="gemma2-27b"),
    "mamba2": dict(arch="mamba2-2.7b"),
    "rgemma": dict(arch="recurrentgemma-9b"),
    "dsv3": dict(arch="deepseek-v3-671b"),
    "qwen2moe": dict(arch="qwen2-moe-a2.7b"),
    # every parameter and moment also cut over "data"
    "fsdp": dict(arch="qwen3-4b", overrides={"fsdp": True}),
    # 3 rows do not divide data 2: every rank holds all rows
    "rows3": dict(arch="qwen3-4b", batch=3),
    # 2 microbatches: a rank's shard of each, the gradients summed in f32
    "micro2": dict(arch="gemma2-27b", overrides={"microbatch": 2}),
    # experts over capacity in each data shard's buffers
    "skew": dict(arch="qwen2-moe-a2.7b", skew=True),
    "dsv3_skew": dict(arch="deepseek-v3-671b", skew=True),
    # (pod=2, data=2, model=2) with the k-means gradient compression on
    # axis_name="pod"
    "pod_gc": dict(arch="qwen3-4b", mesh={"pod": 2, "data": 2, "model": 2},
                   grad_compress=True),
}
MESH = {"data": 2, "model": 4}


def case(name: str) -> dict:
    c = dict(batch=BATCH, mesh=MESH, overrides={}, skew=False,
             grad_compress=False)
    c.update(CASES[name])
    return c


def config(name: str, get_reduced):
    """The case's config from a package's ``configs.get_reduced``, in
    f32."""
    return dataclasses.replace(get_reduced(case(name)["arch"]),
                               dtype="float32")


def skew_router(params):
    """Scale router column 0 of every MoE layer (a numpy tree in the
    reference's layout, changed in place): expert 0's logit then decides
    most tokens' choice."""
    def walk(t):
        if isinstance(t, dict):
            for k, v in t.items():
                if k == "moe" and "router" in v:
                    v["router"] = np.array(v["router"])
                    v["router"][..., 0] *= SKEW
                else:
                    walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    walk(params)
    return params


class _Drops:
    """Records each MoE call's ``drop_frac`` while the block runs."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.orig, self.fracs = moe, moe.apply_moe, []

        def apply_moe(p, x, cfg):
            y, m = self.orig(p, x, cfg)
            self.fracs.append(float(m["drop_frac"]))
            return y, m

        moe.apply_moe = apply_moe
        return self

    def __exit__(self, *exc):
        self.moe.apply_moe = self.orig


def mesh_of(shape: dict):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def gathered(tree, specs, rules):
    """Every leaf of a tree of blocks gathered whole (a collective on
    every rank), in the tree's structure."""
    from repro_torch.core import tree as tree_mod
    from repro_torch.sharding import rules as shard_rules

    return tree_mod.unflatten(tree, [
        shard_rules.gather_block(b, s, rules)
        for b, s in zip(tree_mod.leaves(tree), specs)])


def train_case(name: str, params_np, mesh, plant=None):
    """One case on this rank: (losses, grad norms, last metrics, max drop
    fraction seen, the gathered (params, m, v) in the reference layout on
    rank 0)."""
    import torch.distributed as dist

    from repro_torch import bridge, configs
    from repro_torch.core import grad_compress
    from repro_torch.core import tree as tree_mod
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as shard_rules

    c = case(name)
    cfg = config(name, configs.get_reduced)
    cell = ShapeCell("t", SEQ, c["batch"], "train")
    opts = steps.pick_options(cfg, mesh, cell, **c["overrides"])
    aw = adamw.AdamWConfig(**AW)
    gt = (grad_compress.make_grad_transform(grad_compress.CompressConfig(),
                                            axis_name="pod")
          if c["grad_compress"] else None)
    step, info = steps.lower_step(cfg, mesh, cell, opts, aw, gt)
    p = bridge.params_from_numpy(params_np, cfg, "cpu")
    p, o = shard_rules.place_train_state(p, adamw.init(p), step.rules)
    data = pipeline.SyntheticLM(cfg, pipeline.DataConfig(
        seed=0, global_batch=c["batch"], seq_len=SEQ))
    losses, norms = [], []
    with _Drops() as drops:
        for s in range(STEPS):
            if plant is not None:
                with plant(step):
                    p, o, m = step(p, o, data.batch_at(s))
            else:
                p, o, m = step(p, o, data.batch_at(s))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    whole = [gathered(t, step.specs(t), step.rules) for t in (p, o.m, o.v)]
    out = {"losses": losses, "norms": norms, "options": info["options"],
           "metrics": {k: float(v) for k, v in m.items()},
           "drop": max(drops.fracs, default=0.0), "rows": step.rows,
           "blocks": [tuple(b.shape) for b in tree_mod.leaves(p)]}
    if dist.get_rank() == 0:
        out["tree"] = [bridge.params_to_numpy(t, cfg) for t in whole]
    return out


class sum_over_model:
    """A planted fault: the first leaf cut over ``model`` has its gradient
    summed over ``model`` as well as over the rows (every model rank
    computed the same contribution, so it comes out ``model`` times too
    large)."""

    def __init__(self, step):
        from repro_torch.sharding import rules as shard_rules

        self.mod = shard_rules

    def __enter__(self):
        orig = self.orig = self.mod.reduce_block
        planted = []

        def reduce_block(g, spec, rules, rows):
            if not planted and any(a and "model" in a for a in spec):
                planted.append(spec)
                rows = tuple(rows) + ("model",)
            return orig(g, spec, rules, rows)

        self.mod.reduce_block = reduce_block

    def __exit__(self, *exc):
        self.mod.reduce_block = self.orig


PLANTS = {"sum_over_model": sum_over_model}


def train_main(rank, world, cases, weights, plant=None):
    """Every case of ``cases`` on this rank ({name: result});
    ``weights[name]`` its starting parameters; ``plant`` a key of
    ``PLANTS`` applied to every case."""
    torch.manual_seed(0)
    meshes = {}
    out = {}
    for name in cases:
        shape = case(name)["mesh"]
        key = tuple(shape.items())
        if key not in meshes:
            meshes[key] = mesh_of(shape)
        out[name] = train_case(name, weights[name], meshes[key],
                               PLANTS.get(plant))
    return out
