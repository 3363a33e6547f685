"""End-to-end driver: train a small LM for a few hundred steps (the port's
twin of ``examples/train_lm.py``: the same SMALL config, flags and printed
lines).

Exercises the whole training path of ``repro_torch``: config → model →
AdamW + schedule → deterministic data pipeline → checkpoint / resume →
straggler stats (on the card, the ``bitserial_median`` kernel).
Optionally enables the paper's k-means-codebook gradient compression.

Run: PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
     [--compress] [--device cpu]
"""

import argparse
import os
import tempfile

from repro_torch.core import grad_compress
from repro_torch.data import pipeline
from repro_torch.launch import steps as steps_mod
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig

# ~15M params; the same family as the assigned dense archs (GQA + SwiGLU +
# RoPE)
SMALL = ModelConfig(name="small-lm", family="dense", n_layers=4, d_model=256,
                    n_heads=8, n_kv_heads=4, head_dim=32, d_ff=1024,
                    vocab=2048, pad_vocab_multiple=128, dtype="float32")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--compress", action="store_true",
                    help="cross-pod k-means gradient compression")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_example_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()

    aw = adamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps)
    gt = (grad_compress.make_grad_transform(grad_compress.CompressConfig())
          if args.compress else None)
    step_fn = steps_mod.make_train_step(
        SMALL, aw, steps_mod.StepOptions(remat=False), grad_transform=gt)

    data = pipeline.SyntheticLM(SMALL, pipeline.DataConfig(
        seed=0, global_batch=args.batch, seq_len=args.seq))
    tcfg = TrainerConfig(n_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=max(50, args.steps // 4), log_every=20)
    trainer = Trainer(SMALL, tcfg, aw, step_fn, data, device=args.device)
    trainer.run()
    n = len(trainer.losses)
    print(f"[example] loss: {trainer.losses[0]:.3f} → "
          f"{sum(trainer.losses[-5:]) / 5:.3f} over {n} steps"
          + (" (with gradient compression)" if args.compress else ""))


if __name__ == "__main__":
    main()
