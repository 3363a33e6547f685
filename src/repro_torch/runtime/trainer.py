"""Training runtime (port of ``repro.runtime.trainer``): checkpoint /
restart fault tolerance and straggler statistics around a plain loop.

  * resume: on start, restore the latest committed checkpoint and go on
    from its step; the data pipeline is stateless-seekable, so batches
    replay identically;
  * periodic and final checkpoints, in the reference's tree layout and
    on-disk format (``bridge`` restacks the port's layers), so that a
    checkpoint written by either package restores in the other;
  * straggler detection: each step's wall time against the median and
    MAD (median absolute deviation) of the last <= 64, computed on the
    trainer's device by the paper's bit-serial median
    (``core.bitserial.median``, 16 bits; on the card the
    ``bitserial_median`` kernel, two launches a step from the eighth
    step): a step slower than median + 6 MAD is flagged and logged;
  * ``fail_at_step``: an injected failure, for tests.

On a mesh (a ``step_fn`` from ``launch.steps.lower_step``, which carries
its ``rules``) every rank runs the same loop on its blocks: the starting
parameters are placed by ``rules.place_train_state``; a resume restores
each leaf's block onto the *current* mesh (``ckpt.restore(specs=,
rules=)``), so a job may restart on another topology; checkpoints go
through ``ckpt.save_gathered`` (blocking: each leaf gathered whole, rank 0
writing the one-device format).  The straggler verdict is taken once for
the world: the step time is the slowest rank's (one ``all_reduce`` MAX,
what the reference's single controller times), so every rank computes
the same median and MAD and flags the same steps.  Rank 0 prints.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.checkpoint import ckpt
from repro_torch.core import bitserial
from repro_torch.core import tree as tree_mod
from repro_torch.launch.mesh import mesh_sizes
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import resolve_device
from repro_torch.optim import adamw
from repro_torch.sharding import rules as shard_rules


@dataclasses.dataclass
class TrainerConfig:
    n_steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10
    async_ckpt: bool = False
    fail_at_step: Optional[int] = None   # fault injection for tests
    straggler_mad_factor: float = 6.0


class Trainer:
    """Runs ``step_fn(params, opt_state, batch) -> (params, opt_state,
    metrics)`` over ``data.batch_at(step)``.  ``device`` None means CUDA;
    ``init_params_fn`` (default: ``init_params`` seed 0 on the device)
    gives the starting parameters (whole) when no checkpoint is
    committed.  A ``step_fn`` with ``rules`` (a mesh step) runs on the
    mesh (module docstring)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 aw: adamw.AdamWConfig, step_fn: Callable, data,
                 init_params_fn: Optional[Callable] = None, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.aw = aw
        self.step_fn = step_fn
        self.data = data
        self.device = resolve_device(device)
        self.init_params_fn = init_params_fn or (
            lambda: tfm.init_params(0, cfg, device=self.device))
        self.rules = getattr(step_fn, "rules", None)
        self.step_times: list[float] = []
        self.stragglers: list[int] = []
        self.losses: list[float] = []
        self.grad_norms: list[float] = []

    def say(self, line: str) -> None:
        """Print, once for the world on a mesh (rank 0)."""
        if self.rules is None or dist.get_rank() == 0:
            print(line)

    def _init_state(self):
        params = self.init_params_fn()
        return params, adamw.init(params), 0

    def restore_or_init(self):
        latest = ckpt.latest_step(self.tcfg.ckpt_dir)
        params, opt_state, start = self._init_state()
        if latest is not None:
            like = {"params": bridge.params_to_meta(params, self.cfg),
                    "opt": adamw.OptState(
                        bridge.params_to_meta(opt_state.m, self.cfg),
                        bridge.params_to_meta(opt_state.v, self.cfg),
                        opt_state.step)}
            specs = None
            if self.rules is not None:
                ps = shard_rules.tree_param_specs(like["params"], self.rules)
                specs = {"params": ps, "opt": adamw.OptState(ps, ps, ())}
            del params, opt_state
            tree, start = ckpt.restore(self.tcfg.ckpt_dir, like,
                                       specs=specs, rules=self.rules)
            dev = like["opt"].step.device
            params = bridge.params_from_numpy(tree["params"], self.cfg, dev)
            opt_state = bridge.opt_state_from_numpy(tree["opt"], self.cfg,
                                                    dev)
            self.say(f"[trainer] resumed from step {start}")
        elif self.rules is not None:
            params, opt_state = shard_rules.place_train_state(
                params, opt_state, self.rules)
        return params, opt_state, start

    def run(self):
        params, opt_state, start = self.restore_or_init()
        pending = None
        for step in range(start, self.tcfg.n_steps):
            if self.tcfg.fail_at_step is not None \
                    and step == self.tcfg.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            batch = self.data.batch_at(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = self._world_time(time.perf_counter() - t0)
            self.step_times.append(dt)
            self.losses.append(float(metrics["loss"]))
            self.grad_norms.append(float(metrics["grad_norm"]))
            self._check_straggler(step, dt)
            if (step + 1) % self.tcfg.log_every == 0:
                self.say(f"[trainer] step {step + 1}: "
                         f"loss {self.losses[-1]:.4f} ({dt * 1e3:.0f} ms)")
            if (step + 1) % self.tcfg.ckpt_every == 0:
                if pending is not None:
                    pending.join()
                pending = self._save(params, opt_state, step + 1)
        if pending is not None:
            pending.join()
        self._save(params, opt_state, self.tcfg.n_steps, blocking=True)
        if self.rules is None or dist.get_rank() == 0:
            ckpt.prune(self.tcfg.ckpt_dir, self.tcfg.keep_ckpts)
        return params, opt_state

    def _save(self, params, opt_state, step, blocking=None):
        """A blocking save copies and writes one leaf at a time; an async
        one snapshots the whole tree to host memory first.  On a mesh the
        save is blocking, each leaf gathered from the ranks' blocks."""
        if self.rules is not None:
            def gathering(tree):
                return tree_mod.unflatten(tree, [
                    (lambda b=b, s=s: shard_rules.gather_block(
                        b.detach(), s, self.rules).cpu())
                    for b, s in zip(tree_mod.leaves(tree),
                                    self.step_fn.specs(tree))])

            tree = {"params": bridge.params_to_host(gathering(params),
                                                    self.cfg),
                    "opt": adamw.OptState(
                        bridge.params_to_host(gathering(opt_state.m),
                                              self.cfg),
                        bridge.params_to_host(gathering(opt_state.v),
                                              self.cfg),
                        opt_state.step.detach().cpu())}
            return ckpt.save_gathered(self.tcfg.ckpt_dir, step, tree)
        tree = {"params": bridge.params_to_host(params, self.cfg),
                "opt": bridge.opt_state_to_host(opt_state, self.cfg)}
        return ckpt.save(self.tcfg.ckpt_dir, step, tree,
                         blocking=(not self.tcfg.async_ckpt
                                   if blocking is None else blocking))

    def _world_time(self, dt: float) -> float:
        """The step's time for the straggler verdict: this rank's, or on a
        mesh the slowest rank's."""
        if self.rules is None:
            return dt
        t = torch.tensor([dt], dtype=torch.float64, device=self.device)
        shard_rules.all_reduce(t, tuple(mesh_sizes(self.rules.mesh)),
                               self.rules, op="max")
        return float(t[0])

    def _check_straggler(self, step: int, dt: float):
        """Robust outlier detection on step times (the paper's median
        engine, on the trainer's device)."""
        if len(self.step_times) < 8:
            return
        times = torch.tensor(self.step_times[-64:], dtype=torch.float32,
                             device=self.device)[:, None]
        med = bitserial.median(times, bits=16)[0]
        mad = bitserial.median(torch.abs(times - med), bits=16)[0]
        med, mad = float(med), float(mad)
        if dt > med + self.tcfg.straggler_mad_factor * mad and mad > 0:
            self.stragglers.append(step)
            self.say(f"[trainer] straggler: step {step} took "
                     f"{dt * 1e3:.0f} ms (median {med * 1e3:.0f} ms)")
