#!/usr/bin/env python3
"""Whether a recurrent layer's one-token decode gives a row the same bits
at batch 1 as inside a batch of 4 on the card, op by op.

    python3 benchmarks/recurrent_rows.py

Chunked admission steps every slot's column as one batch of B = 4 rows;
blocking admission steps one prompt as a batch of 1 (``recurrent_mode=
"sequential"``).  For one layer of mamba2-2.7b ('M') and of
recurrentgemma-9b ('R') at full width (bf16 weights from seed 0, random
state and inputs from ``default_rng(0)``), this runs the decode's ops on
a batch of 4 rows and on row 0 alone and prints, for each op, whether
row 0's result is bit-equal (else the largest difference): the GEMMs at M = 1-4 rows against M = 1,
an elementwise op, and for 'M' the state read-out (a batched matmul over
slots x heads) and the f32 means of the RMSNorms.  Needs a CUDA card.
"""

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def st_heads(cfg) -> int:
    return cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim


def main() -> int:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
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
        """'True', or 'False (max |diff| d, row 0's max |value| v)'."""
        if torch.equal(a[:1], b):
            return "True"
        d = (a[:1].float() - b.float()).abs().max().item()
        return f"False (max |diff| {d:.3e}, |row| {b.abs().max().item():.3e})"

    torch.manual_seed(0)
    for arch in ("mamba2-2.7b", "recurrentgemma-9b"):
        cfg = configs.get_config(arch)
        kind = "M" if cfg.ssm is not None else "R"
        gen = torch.Generator(device=dev).manual_seed(0)
        p = tfm.init_sublayer(gen, cfg, kind, dev)
        pp = p["ssm"] if kind == "M" else p["rg"]
        init = (ssm_mod.init_cache_ssm if kind == "M"
                else rg_mod.init_cache_rglru)
        shapes = {k: (v.shape, v.dtype) for k, v in init(cfg, 4,
                                                         device=dev).items()}
        state = {k: rand(s, dt, 0.3) for k, (s, dt) in shapes.items()}
        x = rand((4, 1, cfg.d_model), torch.bfloat16)
        step = (ssm_mod.ssm_decode if kind == "M" else rg_mod.rglru_decode)
        with torch.inference_mode():
            y4, s4 = step(pp, x, cfg, state)
            y1, s1 = step(pp, x[:1], cfg, {k: v[:1] for k, v in
                                           state.items()})
            print(f"{arch} '{kind}' decode: y row 0 equal {same(y4, y1)}; "
                  + ", ".join(f"{k} equal {same(s4[k], s1[k])}"
                              for k in s4), flush=True)
            # op by op, on the same rounded inputs
            first = pp["in_proj"] if kind == "M" else pp["wg"]
            a4, a1 = x @ first, x[:1] @ first
            print(f"  x @ {'in_proj' if kind == 'M' else 'wg'} "
                  f"({cfg.d_model} x {first.shape[1]}, bf16): row 0 equal "
                  f"{same(a4, a1)}", flush=True)
            if kind == "R":
                u = rand((4, cfg.lru_width), torch.float32)
                g4, g1 = u @ pp["wa_gate"], u[:1] @ pp["wa_gate"]
                print(f"  u @ wa_gate ({cfg.lru_width} x {cfg.lru_width}, "
                      f"f32): row 0 equal {same(g4, g1)}", flush=True)
            last = pp["out_proj"] if kind == "M" else pp["rg_out"]
            z = rand((4, 1, last.shape[0]), torch.bfloat16)
            o4, o1 = z @ last, z[:1] @ last
            print(f"  @ {'out_proj' if kind == 'M' else 'rg_out'} "
                  f"({last.shape[0]} x {last.shape[1]}, bf16): row 0 "
                  f"equal {same(o4, o1)}", flush=True)
            for m in (2, 3, 4):
                print(f"  x[:{m}] @ {'in_proj' if kind == 'M' else 'wg'}"
                      f" row 0 equal to M = 1: "
                      f"{same(x[:m] @ first, a1)}; 2-D "
                      f"{same(x[:m, 0] @ first, x[:1, 0] @ first)}",
                      flush=True)
            e = F.silu(a4.float())
            print(f"  elementwise (silu on f32) row 0 equal "
                  f"{same(e, F.silu(a1.float()))}", flush=True)
            if kind == "M":
                # the ops after the state update, on the batch's rounded
                # inputs: the state read-out and the gated RMSNorm
                st, c = state["ssm"], rand(
                    (4, st_heads(cfg), cfg.ssm.d_state), torch.float32)
                r4, r1 = st @ c[..., None], st[:1] @ c[:1, ..., None]
                print(f"  state read-out st @ C ({tuple(st.shape)} @ "
                      f"{tuple(c.shape)}[..., None], f32 bmm): row 0 equal "
                      f"{same(r4, r1)}", flush=True)
                g = rand((4, 1, last.shape[0]), torch.float32)
                m4, m1 = (g * g).mean(-1), (g[:1] * g[:1]).mean(-1)
                print(f"  (g * g).mean(-1) over {last.shape[0]} (f32): row 0"
                      f" equal {same(m4, m1)}", flush=True)
                h = rand((4, 1, cfg.d_model), torch.float32)
                n4, n1 = (h * h).mean(-1), (h[:1] * h[:1]).mean(-1)
                print(f"  (h * h).mean(-1) over {cfg.d_model} (f32): row 0 "
                      f"equal {same(n4, n1)}", flush=True)
        del p
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
