"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --reduced --steps 200 --batch 8 --seq 128 [--device cpu]

Runs on the card unless ``--device`` names another device.  ``--reduced``
takes the family-preserving small config, else the full published one.
Checkpoint / restart, straggler logging and the optional k-means
gradient compression are wired through.

``--mesh host`` in a process that is no rank of a world (no initialised
``torch.distributed`` world, no ``torchrun`` environment) trains on the
one device.  Under ``torchrun`` each process is a rank (NCCL on CUDA, one
card a rank; gloo on the CPU) and the ranks train on
``launch.mesh.make_host_mesh()``'s (world, 1) mesh with ``pick_options``
and ``lower_step``'s step (``launch.steps.MeshTrainStep``), the rows of
each batch split over them; rank 0 prints:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch \
        qwen3-4b --mesh host --batch 4 --seq 1024 --steps 10 --lr 3e-4

``--mesh pod`` / ``multipod`` train on the production mesh, (data=16,
model=16) or (pod=2, data=16, model=16), which needs a world of 256 /
512 ranks; ``--grad-compress`` under ``multipod`` names the cross-pod
axis (``axis_name="pod"``).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch.distributed as dist

from repro_torch import configs
from repro_torch.core import grad_compress
from repro_torch.data import pipeline
from repro_torch.launch import preboot
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ShapeCell
from repro_torch.models.layers import resolve_device
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_IDS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="host", choices=["host", "pod",
                                                       "multipod"])
    ap.add_argument("--grad-compress", action="store_true",
                    help="k-means codebook gradient compression")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    dev = resolve_device(args.device)
    aw = adamw.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                           total_steps=args.steps)
    if preboot.is_rank():
        preboot.init_world(dev)
    mesh = None
    if args.mesh != "host" or dist.is_initialized():
        try:
            mesh = (make_host_mesh() if args.mesh == "host" else
                    make_production_mesh(multi_pod=args.mesh == "multipod"))
        except ValueError as e:
            ap.error(f"--mesh {args.mesh}: {e}")
    gt = None
    if args.grad_compress:
        gt = grad_compress.make_grad_transform(
            grad_compress.CompressConfig(),
            axis_name="pod" if args.mesh == "multipod" else None)
    if mesh is None:
        opts = steps_mod.StepOptions(remat=True)
        step_fn = steps_mod.make_train_step(cfg, aw, opts, grad_transform=gt)
    else:
        cell = ShapeCell("cli", args.seq, args.batch, "train")
        opts = steps_mod.pick_options(cfg, mesh, cell, remat=True)
        step_fn, _ = steps_mod.lower_step(cfg, mesh, cell, opts, aw, gt)
    data = pipeline.SyntheticLM(cfg, pipeline.DataConfig(
        seed=args.seed, global_batch=args.batch, seq_len=args.seq))
    tcfg = TrainerConfig(n_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, log_every=10)
    trainer = Trainer(cfg, tcfg, aw, step_fn, data,
                      init_params_fn=lambda: tfm.init_params(
                          args.seed, cfg, device=dev), device=dev)
    trainer.run()
    trainer.say(f"[train] done: final loss {trainer.losses[-1]:.4f}, "
                f"stragglers flagged: {len(trainer.stragglers)}")
    return trainer


if __name__ == "__main__":
    main()
    preboot.leave_world()
