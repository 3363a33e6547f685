"""``train_loss``, its metrics and the gradient of every parameter leaf,
port against reference, for the attention-only families of the zoo:
qwen3-4b, gemma2-27b, gemma3-4b, internvl2-76b (the frontend stub: patch
positions stripped before the loss) and seamless-m4t-medium (the
encoder-decoder).  The recurrent and MoE families (and MTP) are in
tests/test_torch_train_loss_mix.py.

f32 at the reduced configs, one SyntheticLM batch of 2 x 24, loss chunks
of 8 (tests/_torch_train.py).  Tolerances: the loss and each metric within
1e-5; each gradient leaf within 1e-4 of its largest reference entry.  The
port runs with remat (``forward_trunk``'s checkpointed repeats), the
reference without (the same math).
"""

import jax
import pytest

from _torch_train import (close, grads_close, port_loss_and_grads,
                          ref_loss_and_grads, model)
from repro_torch import bridge

ARCHS = ["qwen3-4b", "gemma2-27b", "gemma3-4b", "internvl2-76b",
         "seamless-m4t-medium"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match(arch):
    loss, metrics, grads = ref_loss_and_grads(arch)
    loss_t, metrics_t, grads_t = port_loss_and_grads(arch)
    close(float(loss_t), loss, f"{arch} loss")
    assert set(metrics_t) == set(metrics)
    for k in metrics:
        close(float(metrics_t[k]), metrics[k], f"{arch} {k}")
    _, cfg_t, _, _ = model(arch)
    n = grads_close(bridge.params_to_numpy(grads_t, cfg_t), grads, arch)
    assert n == len(jax.tree.leaves(grads))
