"""The ranks of tests/test_torch_train_elastic.py's and
tests/test_torch_train_cli_mesh.py's gloo worlds (run through
``_torch_world``; imports neither JAX nor the reference): elastic
restores and saves of a checkpoint on a mesh, the mesh Trainer (crash and
resume, a planted straggler) and the training CLI.

The model is the reduced qwen3-4b in f32 (``_torch_train_ranks.config``)
on the reference's weights that the caller bridged; the Trainer's cell is
``TRAINER_BATCH`` rows of ``TRAINER_SEQ`` tokens (8 rows: one a rank on
an 8 x 1 mesh).
"""

import contextlib
import io
import time

import torch

import _torch_train_ranks as ranks

TRAINER_BATCH, TRAINER_SEQ = 8, 16
TRAINER_AW = dict(lr=1e-3, warmup_steps=0)


def _cfg():
    from repro_torch import configs

    return ranks.config("qwen3", configs.get_reduced)


def _like(cfg):
    """The checkpoint template (the reference's layout, whole shapes on
    meta) and its specs under ``rules``."""
    from repro_torch import bridge
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw

    p = tfm.init_params(torch.Generator(), cfg, device="meta")
    o = adamw.init(p)
    return {"params": bridge.params_to_meta(p, cfg),
            "opt": adamw.OptState(bridge.params_to_meta(o.m, cfg),
                                  bridge.params_to_meta(o.v, cfg), o.step)}


def _flat(tree) -> dict:
    from repro_torch.checkpoint import ckpt

    return {"/".join(path): leaf.detach().numpy().copy()
            for path, leaf in ckpt._items(tree)}


def restore_main(rank, world, ckpt_dir, shape):
    """This rank's block of every leaf of the checkpoint at ``ckpt_dir``
    restored onto a mesh of ``shape`` ({key: numpy})."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as shard_rules

    cfg = _cfg()
    rules = steps.step_rules(cfg, ranks.mesh_of(shape), steps.StepOptions())
    like = _like(cfg)
    ps = shard_rules.tree_param_specs(like["params"], rules)
    tree, step = ckpt.restore(ckpt_dir, like, specs={
        "params": ps, "opt": adamw.OptState(ps, ps, ())}, rules=rules)
    return step, _flat(tree)


def _trainer(cfg, mesh, ckpt_dir, n_steps, weights, fail_at=None,
             ckpt_every=2, wrap=None):
    from repro_torch import bridge
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cell = ShapeCell("t", TRAINER_SEQ, TRAINER_BATCH, "train")
    aw = adamw.AdamWConfig(**TRAINER_AW)
    step, _ = steps.lower_step(cfg, mesh, cell, None, aw)
    data = pipeline.SyntheticLM(cfg, pipeline.DataConfig(
        seed=0, global_batch=TRAINER_BATCH, seq_len=TRAINER_SEQ))
    tcfg = TrainerConfig(n_steps=n_steps, ckpt_dir=ckpt_dir,
                         ckpt_every=ckpt_every, log_every=1000,
                         fail_at_step=fail_at)
    return Trainer(cfg, tcfg, aw, wrap(step) if wrap else step, data,
                   init_params_fn=lambda: bridge.params_from_numpy(
                       weights, cfg, "cpu"), device="cpu")


def save_main(rank, world, ckpt_dir, shape, weights, moments):
    """Place the whole state (``weights``, and ``moments`` = (m, v, the
    update count) in the reference's layout, numpy) on a mesh of
    ``shape`` and save it at step 3 through the mesh Trainer's save."""
    from repro_torch import bridge
    from repro_torch.sharding import rules as shard_rules

    cfg = _cfg()
    tr = _trainer(cfg, ranks.mesh_of(shape), ckpt_dir, 3, weights)
    state = bridge.opt_state_from_numpy(moments, cfg, "cpu")
    p = bridge.params_from_numpy(weights, cfg, "cpu")
    p, o = shard_rules.place_train_state(p, state, tr.rules)
    tr._save(p, o, 3)
    return True


def trainer_main(rank, world, ckpt_dir, shape, n_steps, weights,
                 fail_at=None):
    """The mesh Trainer on a mesh of ``shape`` for ``n_steps`` (failing
    at ``fail_at``): (losses, grad norms, whether it failed)."""
    cfg = _cfg()
    tr = _trainer(cfg, ranks.mesh_of(shape), ckpt_dir, n_steps, weights,
                  fail_at)
    failed = False
    try:
        tr.run()
    except RuntimeError as e:
        assert "injected failure" in str(e), e
        failed = True
    return tr.losses, tr.grad_norms, failed


class _Slow:
    """A mesh step that sleeps ``seconds`` on rank ``rank`` at the calls
    numbered ``at`` (0-based), carrying the step's rules and specs."""

    def __init__(self, step, rank, at, seconds):
        import torch.distributed as dist

        self.step, self.rules, self.specs = step, step.rules, step.specs
        self.slow = dist.get_rank() == rank
        self.at, self.seconds, self.calls = set(at), seconds, 0

    def __call__(self, *args):
        out = self.step(*args)
        if self.slow and self.calls in self.at:
            time.sleep(self.seconds)
        self.calls += 1
        return out


STRAGGLER_STEPS, STRAGGLER_AT, STRAGGLER_RANK = 16, (10, 13), 5


def straggler_main(rank, world, ckpt_dir, weights):
    """The mesh Trainer on (data=2, model=4) with rank ``STRAGGLER_RANK``
    sleeping 0.5 s in the steps ``STRAGGLER_AT``: (the flagged steps, the
    step times)."""
    cfg = _cfg()
    tr = _trainer(cfg, ranks.mesh_of(ranks.MESH), ckpt_dir,
                  STRAGGLER_STEPS, weights, ckpt_every=1000,
                  wrap=lambda s: _Slow(s, STRAGGLER_RANK, STRAGGLER_AT, 0.5))
    tr.run()
    return tr.stragglers, tr.step_times


CLI_ARGS = ["--arch", "qwen3-4b", "--reduced", "--steps", "4", "--batch",
            "4", "--seq", "16", "--device", "cpu"]


def cli_main(rank, world, ckpt_dir, argv=()):
    """``launch.train.main`` in this world (``--mesh host``, or ``argv``
    appended): (its final loss or None, what it printed, its stderr, its
    exit code)."""
    from repro_torch.launch import train

    out, err = io.StringIO(), io.StringIO()
    code, loss = 0, None
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            tr = train.main(CLI_ARGS + ["--ckpt-dir", ckpt_dir]
                            + (list(argv) or ["--mesh", "host"]))
            loss = tr.losses[-1]
        except SystemExit as e:
            code = e.code
    return loss, out.getvalue(), err.getvalue(), code
