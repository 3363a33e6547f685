"""Shared pieces of the port's training tests (tests/test_torch_train*.py).

Every architecture runs at its reduced config in f32 on both sides.
Parameters are the reference's ``init_params`` (seed 0) carried across by
``bridge``; batches are ``SyntheticLM``'s numpy streams, which both
packages build alike (checked).  The reference's loss and gradients come
from one jit of ``value_and_grad(train_loss)`` an architecture, built once
a module.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_ref import ref_init_params
from repro import configs
from repro.data import pipeline
from repro.models import moe as moe_ref
from repro.models import transformer as tfm
from repro_torch import bridge
from repro_torch import configs as configs_t
from repro_torch.core import tree
from repro_torch.data import pipeline as pipeline_t
from repro_torch.models import moe as moe_t
from repro_torch.models import transformer as tfm_t

#: tests/test_models_parity.py::test_decode_matches_forward's seven
DECODE_ARCHS = ["qwen3-4b", "gemma2-27b", "gemma3-4b", "mamba2-2.7b",
                "recurrentgemma-9b", "deepseek-v3-671b", "qwen2-moe-a2.7b"]
#: a batch of 2 x 24 tokens (internvl2: 4 patch embeddings and 20 tokens;
#: seamless: 12 encoder frames and 12 tokens), loss chunks of 8
SEQ, BATCH, CHUNK = 24, 2, 8

#: the loss and the metrics: within 1e-5 (relative and absolute); a
#: gradient leaf: max |port - reference| <= GRAD_TOL x max |reference|
GRAD_TOL = 1e-4


def configs_f32(arch):
    return (dataclasses.replace(configs.get_reduced(arch), dtype="float32"),
            dataclasses.replace(configs_t.get_reduced(arch),
                                dtype="float32"))


@functools.lru_cache(maxsize=None)
def model(arch):
    """(cfg, cfg_t, reference params (numpy leaves), port params)."""
    cfg, cfg_t = configs_f32(arch)
    p = jax.tree.map(np.asarray, ref_init_params(cfg))
    return cfg, cfg_t, p, bridge.params_from_numpy(p, cfg_t, "cpu")


def batch(arch, step=0):
    """The step's SyntheticLM batch (numpy), equal in both packages."""
    cfg, cfg_t = configs_f32(arch)
    dc = dict(seed=0, global_batch=BATCH, seq_len=SEQ)
    b = pipeline.SyntheticLM(cfg, pipeline.DataConfig(**dc)).batch_at(step)
    bt = pipeline_t.SyntheticLM(cfg_t, pipeline_t.DataConfig(**dc)).batch_at(
        step)
    assert b.keys() == bt.keys()
    for k in b:
        np.testing.assert_array_equal(bt[k], b[k], err_msg=k)
    return b


@functools.lru_cache(maxsize=None)
def ref_loss_and_grads(arch):
    """The reference's (loss, metrics, grads) on :func:`batch`, numpy."""
    cfg, _, p, _ = model(arch)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: tfm.train_loss(p, cfg, b, remat=False,
                                    loss_chunk=CHUNK), has_aux=True))
    (loss, metrics), grads = fn(p, {k: jnp.asarray(v)
                                    for k, v in batch(arch).items()})
    return (np.asarray(loss), jax.tree.map(np.asarray, metrics),
            jax.tree.map(np.asarray, grads))


@functools.lru_cache(maxsize=None)
def port_loss_and_grads(arch, remat=True):
    """The port's (loss, metrics, grads in the port's layout) on
    :func:`batch`, with the reference's expert sets checked equal first
    on every MoE layer's input (see :func:`expert_sets_agree`)."""
    _, cfg_t, _, pt = model(arch)
    pt = tree.map_(lambda t: t.detach().clone().requires_grad_(True), pt)
    b = {k: torch.from_numpy(v) for k, v in batch(arch).items()}
    with expert_sets_agree(configs_f32(arch)[0]):
        loss, metrics = tfm_t.train_loss(pt, cfg_t, b, remat=remat,
                                         loss_chunk=CHUNK)
    leaves = tree.leaves(pt)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree.unflatten(pt, grads))


class expert_sets_agree:
    """Within the block, every port MoE layer also routes its input
    through the reference's ``route`` and asserts that each token's top-k
    expert set is the same: a near-tie that flips between the packages
    would make a loss or gradient comparison meaningless."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.checked = 0

    def __enter__(self):
        self.orig = moe_t.apply_moe

        def apply_moe(p, x, cfg_t):
            with torch.no_grad():   # saves nothing a recompute would miss
                _, idx, _ = moe_t.route(p, x.reshape(-1, x.shape[-1]), cfg_t)
            _, idx_r, _ = moe_ref.route(
                {k: jnp.asarray(p[k].detach().numpy())
                 for k in ("router", "bias")},
                jnp.asarray(x.detach().reshape(-1, x.shape[-1]).numpy()),
                self.cfg)
            got = np.sort(idx.numpy(), axis=1)
            want = np.sort(np.asarray(idx_r), axis=1)
            np.testing.assert_array_equal(got, want,
                                          err_msg="MoE expert sets")
            self.checked += 1
            return self.orig(p, x, cfg_t)

        moe_t.apply_moe = apply_moe
        return self

    def __exit__(self, *exc):
        moe_t.apply_moe = self.orig


def close(got, want, what, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def grads_close(got_ref_layout, want, what=""):
    """Every gradient leaf (both in the reference's layout, numpy) within
    ``GRAD_TOL`` of the reference's largest entry; returns the leaves
    compared."""
    got = dict(jax.tree_util.tree_flatten_with_path(got_ref_layout)[0])
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(got) == len(flat), (len(got), len(flat))
    for kp, w in flat:
        g = got[kp]
        assert g.shape == w.shape, (jax.tree_util.keystr(kp), g.shape)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.astype(np.float32) - w).max())
        assert err <= GRAD_TOL * scale, (
            f"{what} grad {jax.tree_util.keystr(kp)}: max err {err:.3g} "
            f"over max |g| {scale:.3g}")
    return len(flat)
