"""``train_loss``, its metrics and the gradient of every parameter leaf,
port against reference, for the recurrent and MoE families: mamba2-2.7b
('M'), recurrentgemma-9b ('RRL'), qwen2-moe-a2.7b and deepseek-v3-671b
(MLA, a dense prefix, MoE, and DeepSeek's MTP head: its loss weighted 0.3,
and its leaves' gradients).  Every MoE layer's expert sets are asserted
equal between the packages before the comparison (a near-tie would flip a
routing decision).  Setup and tolerances as tests/test_torch_train_loss.py.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_train import (batch, close, configs_f32, grads_close, model,
                          port_loss_and_grads, ref_loss_and_grads)
from repro_torch import bridge
from repro_torch.models import transformer as tfm_t

ARCHS = ["mamba2-2.7b", "recurrentgemma-9b", "qwen2-moe-a2.7b",
         "deepseek-v3-671b"]


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


def test_mtp_loss_and_leaves():
    """The reduced deepseek-v3's MTP head: ``_mtp_loss`` alone equals the
    reference's "mtp_loss" metric, the loss is nll + 0.3 x mtp + aux, and
    every "mtp" leaf's gradient is nonzero and matches."""
    arch = "deepseek-v3-671b"
    cfg, cfg_t = configs_f32(arch)
    loss, metrics, grads = ref_loss_and_grads(arch)
    _, _, _, pt = model(arch)
    b = {k: torch.from_numpy(v) for k, v in batch(arch).items()}
    with torch.no_grad():
        h, _ = tfm_t.forward_trunk(pt, cfg_t, b["tokens"], remat=False)
        mtp = tfm_t._mtp_loss(pt, cfg_t, h, b, 1, 8)
    close(float(mtp), metrics["mtp_loss"], "mtp_loss")
    close(float(loss), metrics["nll"] + 0.3 * metrics["mtp_loss"]
          + metrics["aux_loss"], "loss = nll + 0.3 mtp + aux")
    _, _, grads_t = port_loss_and_grads(arch)
    got = bridge.params_to_numpy(grads_t, cfg_t)["mtp"]
    assert grads_close(got, grads["mtp"], "mtp") == len(
        jax.tree.leaves(grads["mtp"]))
    for name in ("proj", "norm_h", "norm_e", "final_norm"):
        leaf = got[name] if name == "proj" else got[name]["scale"]
        assert np.abs(leaf).max() > 0, name
