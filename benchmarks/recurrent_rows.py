#!/usr/bin/env python3
"""Whether a recurrent layer gives a row the same bits whatever the
number of rows beside it on the card, op by op (ROADMAP Queue C 10).

    python3 benchmarks/recurrent_rows.py

Chunked admission steps every slot's column as one batch of the engine's
B = 4 slots; blocking admission steps one prompt's columns at batch 1
unless ``transformer._pad_rows`` pads them to the slot count; after the
dense bucket shrinks, decode steps run at 2 or 1 rows.  For one layer of
mamba2-2.7b ('M') and of recurrentgemma-9b ('R') at full width (bf16
weights from seed 0, random state and inputs from ``default_rng(0)``),
this prints:

1. the one-token decode walked op by op (every non-view aten op the
   column step dispatches, in order): row 0 at M = 1 and M = 2 rows
   against M = 4, then at 1 row padded to 4 against 4 (the repair), with
   the first op whose row 0 differs;
2. one whole column of a chunk of 64: ``transformer._recurrent_mixed_
   advance`` (slot 0 admitting, slots 1-3 decoding) against the
   sequential prefill of the same 64 positions at 1 row and padded to 4,
   on the outputs and the final state;
3. the ops outside the column loop: ``norm1`` at (1, S, d) rows (a
   blocking prompt of S = 110) against (4, 64, d) (a chunked step), and
   at (2, 1, d) against (4, 1, d) (a decode after the shrink); for 'R'
   the ``_ffn`` (norm2 and the bf16 MLP) at the same row counts; and the
   f32 vocabulary projection ``lm_logits`` at 1 and 2 rows against 4.

Each line reads "True" (bit-equal) or "False (max |diff| d, |row| v)".
Needs a CUDA card.
"""

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.models import layers
    from repro_torch.models import rglru as rg_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as tfm

    if not torch.cuda.is_available():
        print("recurrent_rows: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def rand(shape, dtype, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(dev, dtype)

    def same(a, b):
        """'True', or 'False (max |diff| d, |row| v)' for a's leading
        rows against b (b has as many rows or fewer)."""
        a = a[:b.shape[0]]
        if torch.equal(a, b):
            return "True"
        d = (a.float() - b.float()).abs().max().item()
        return f"False (max |diff| {d:.3e}, |row| {b.abs().max().item():.3e})"

    class Record(TorchDispatchMode):
        """Every non-view op's name and output, in dispatch order."""

        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view and isinstance(out, torch.Tensor):
                self.ops.append((str(func.overloadpacket.__name__),
                                 out.detach().clone()))
            return out

    def walk(step, pp, cfg, x, state, rows, pad_to=None):
        """(name, output) of every op of one decode at ``rows`` rows of
        (x, state), padded to ``pad_to`` rows when given."""
        xs, st = x[:rows], {k: v[:rows] for k, v in state.items()}
        if pad_to is not None:
            xs, st = tfm._pad_rows(pad_to, xs, st)
        with Record() as rec:
            step(pp, xs, cfg, st)
        return rec.ops

    def first_diff(ops, base, one):
        """'all N ops equal' or the first op whose row 0 differs.  ``one``
        is the walk at 1 row: an op whose output leads with the batch (or
        batch x heads) has k rows there and 4k at 4 rows, and row 0 is
        its first k; an op whose shape does not follow the rows is
        compared whole."""
        if not len(ops) == len(base) == len(one):
            return (f"different op sequences ({len(ops)}, {len(base)}, "
                    f"{len(one)} ops)")
        for i, ((name, a), (_, b), (_, o)) in enumerate(zip(ops, base, one)):
            if o.dim() and o.shape != b.shape and o.shape[0] * 4 == b.shape[0]:
                a, b = a[:o.shape[0]], b[:o.shape[0]]
            if a.shape != b.shape or not torch.equal(a, b):
                return f"first difference at op {i} {name}: {same(b, a)}"
        return f"all {len(ops)} ops equal"

    torch.manual_seed(0)
    for arch in ("mamba2-2.7b", "recurrentgemma-9b"):
        cfg = configs.get_config(arch)
        kind = "M" if cfg.ssm is not None else "R"
        gen = torch.Generator(device=dev).manual_seed(0)
        p = tfm.init_sublayer(gen, cfg, kind, device=dev)
        pp = p["ssm"] if kind == "M" else p["rg"]
        init = (ssm_mod.init_cache_ssm if kind == "M"
                else rg_mod.init_cache_rglru)
        shapes = {k: (v.shape, v.dtype) for k, v in init(cfg, 4,
                                                         device=dev).items()}
        state = {k: rand(s, dt, 0.3) for k, (s, dt) in shapes.items()}
        x = rand((4, 1, cfg.d_model), torch.bfloat16)
        step = (ssm_mod.ssm_decode if kind == "M" else rg_mod.rglru_decode)
        with torch.inference_mode():
            # 1. the decode, op by op
            base = walk(step, pp, cfg, x, state, 4)
            one = walk(step, pp, cfg, x, state, 1)
            for rows, pad in ((1, None), (2, None), (1, 4), (2, 4)):
                ops = walk(step, pp, cfg, x, state, rows, pad)
                tag = f"M = {rows}" + (f" padded to {pad}" if pad else "")
                print(f"{arch} '{kind}' decode op walk, row 0 at {tag} "
                      f"against M = 4: {first_diff(ops, base, one)}",
                      flush=True)

            # 2. one whole column of a 64-token chunk
            L = 64
            xc = rand((4, L, cfg.d_model), torch.bfloat16)
            st0 = {k: v.clone() for k, v in state.items()}
            for v in st0.values():
                v[0] = 0                                  # a fresh admission
            stepf = lambda xt, c: step(pp, xt, cfg, c)    # noqa: E731
            cl = torch.tensor([L, 1, 1, 1], dtype=torch.int32, device=dev)
            ym, sm = tfm._recurrent_mixed_advance(stepf, xc, st0, cl)
            fresh = {k: v[:1].clone() for k, v in st0.items()}
            for rows in (None, 4):
                ys, ss = tfm._recurrent_prefill_sequential(
                    stepf, xc[:1], dict(fresh), rows=rows)
                tag = "1 row" if rows is None else "1 row padded to 4"
                print(f"{arch} '{kind}' column of {L}: sequential prefill at"
                      f" {tag} against the mixed advance at 4 rows: y "
                      f"{same(ym, ys)}; "
                      + ", ".join(f"{k} {same(sm[k], ss[k])}" for k in ss),
                      flush=True)

            # 3. the ops outside the column loop
            S = 110
            h_blk = rand((1, S, cfg.d_model), torch.bfloat16)
            h_chk = rand((4, L, cfg.d_model), torch.bfloat16)
            h_chk[0] = h_blk[0, :L]
            h_dec = rand((4, 1, cfg.d_model), torch.bfloat16)
            fns = [("norm1", lambda h: layers.apply_norm(p["norm1"], h, cfg))]
            if kind == "R":
                fns.append(("_ffn", lambda h: tfm._ffn(p, h, cfg)[0]))
            for name, fn in fns:
                a = fn(h_chk)[0]
                b = fn(h_blk)[0, :L]
                print(f"{arch} '{kind}' {name}: (1, {S}, d) against (4, {L},"
                      f" d), row 0's first {L}: {same(a, b)}; decode (2, 1, "
                      f"d) and (1, 1, d) against (4, 1, d): "
                      f"{same(fn(h_dec), fn(h_dec[:2]))}, "
                      f"{same(fn(h_dec), fn(h_dec[:1]))}", flush=True)
            emb = layers.init_embed(gen, cfg, dev)
            hl = rand((4, 1, cfg.d_model), torch.bfloat16)
            l4 = layers.lm_logits(emb, hl, cfg)
            print(f"{arch} lm_logits (f32, {cfg.d_model} x "
                  f"{cfg.padded_vocab}): M = 1 and M = 2 against M = 4: "
                  f"{same(l4, layers.lm_logits(emb, hl[:1], cfg))}, "
                  f"{same(l4, layers.lm_logits(emb, hl[:2], cfg))}",
                  flush=True)
        del p, emb
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
