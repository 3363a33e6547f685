"""The serving steps of ``repro_torch.launch.steps`` against the
reference's ``repro.launch.steps``, and a guard that the port imports no
JAX.

* Every architecture × every ``SHAPES`` cell at full width on the meta
  device: ``batch_struct`` gives the reference's shapes and dtypes, and
  ``cache_struct``'s bytes equal the reference's ``jax.eval_shape`` cache
  bytes (as ``lower_step``'s ``info["cache_bytes"]`` counts them) in
  every ``kv_mode``; an encoder-decoder's cache comes from a prefill on
  meta, as the reference's comes from one under ``eval_shape``.
* ``make_prefill_step`` / ``make_decode_step`` on the reduced qwen3-4b
  (dense), seamless-m4t-medium (encoder-decoder) and internvl2-76b (a
  vision frontend) in f32, on the reference's weights: logits and every
  cache leaf within 1e-5 of the reference's.
* In a subprocess that cannot import ``jax`` or ``repro``: every module
  of ``repro_torch`` (the mesh's ``launch.mesh``, ``launch.preboot`` and
  ``sharding`` among them), ``examples/*_torch.py`` and ``chip_smoke.py``
  import.
"""

import dataclasses
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.launch import steps as steps_ref
from repro.models.config import SHAPES
from repro.models.config import ShapeCell as ShapeCellRef
from repro_torch import bridge
from repro_torch import configs as configs_t
from repro_torch.core import tree as tree_mod
from repro_torch.launch import steps
from repro_torch.models.config import SHAPES as SHAPES_T
from repro_torch.models.config import ShapeCell

from _torch_ref import ref_init_params

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def test_step_options_are_the_references():
    want = dataclasses.asdict(steps_ref.StepOptions())
    got = dataclasses.asdict(steps.StepOptions())
    assert set(got) <= set(want)
    assert {k: want[k] for k in got} == got
    assert {"kv_mode", "kv_clusters", "kv_tail"} <= set(got)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list(configs.ARCH_IDS))
def test_structs_match_reference(arch, shape):
    cfg, cfg_t = configs.get_config(arch), configs_t.get_config(arch)
    cell, cell_t = SHAPES[shape], SHAPES_T[shape]
    want = steps_ref.batch_struct(cfg, cell)
    got = steps.batch_struct(cfg_t, cell_t)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == w.shape, k
        assert got[k].dtype == getattr(torch, str(w.dtype)), k
    modes = ["exact"] if cfg.is_encdec else ["exact", "clustered", "int8"]
    for mode in modes:
        cs = steps_ref.cache_struct(cfg, cell,
                                    steps_ref.StepOptions(kv_mode=mode))
        want_bytes = sum(math.prod(leaf.shape) * leaf.dtype.itemsize
                         for leaf in jax.tree.leaves(cs))
        cache = steps.cache_struct(cfg_t, cell_t,
                                   steps.StepOptions(kv_mode=mode))
        assert all(t.device.type == "meta"
                   for t in tree_mod.leaves(cache))
        assert steps.cache_bytes(cache) == want_bytes, mode
        assert ("cross" in cache) == cfg.is_encdec


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL, err_msg=what)


@pytest.mark.parametrize("arch", ["qwen3-4b", "seamless-m4t-medium",
                                  "internvl2-76b"])
def test_serving_steps_match_reference(arch):
    """A prefill cell of 32 positions (an encoder-decoder: 16 frames and
    a cache of 16), prompts 8 short of the cache, then two decode steps:
    logits and cache leaves against the reference's."""
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32")
    cfg_t = dataclasses.replace(configs_t.get_reduced(arch),
                                dtype="float32")
    params = ref_init_params(cfg)
    pt = bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg_t,
                                  "cpu")
    cell = ShapeCellRef("small_prefill", 32, 2, "prefill")
    cell_t = ShapeCell("small_prefill", 32, 2, "prefill")
    rng = np.random.default_rng(0)
    batch = {}
    for k, s in steps_ref.batch_struct(cfg, cell).items():
        if k == "tokens":
            shape = (s.shape[0], s.shape[1] - 8)
            batch[k] = rng.integers(0, cfg.vocab, size=shape).astype(
                np.int32)
        else:
            batch[k] = rng.normal(size=s.shape).astype(np.float32)
    lw, cw = jax.jit(steps_ref.make_prefill_step(
        cfg, cell, steps_ref.StepOptions()))(
            params, jax.tree.map(jnp.asarray, batch))
    lg, cg = steps.make_prefill_step(cfg_t, cell_t)(pt, batch)
    _close(lg.numpy(), lw, "prefill logits")

    def caches_close(what):
        want = bridge.cache_from_numpy(jax.tree.map(np.asarray, cw), cfg_t)
        for i, (g, w) in enumerate(zip(tree_mod.leaves(cg),
                                       tree_mod.leaves(want))):
            assert g.shape == w.shape and g.dtype == w.dtype
            _close(g.numpy(), w.numpy(), f"{what} cache leaf {i}")

    caches_close("prefill")
    t0 = batch["tokens"].shape[1] + (0 if cfg.is_encdec
                                     else cfg.n_frontend_tokens)
    decode_ref = jax.jit(steps_ref.make_decode_step(
        cfg, steps_ref.StepOptions()))
    decode = steps.make_decode_step(cfg_t)
    for i in range(2):
        tk = np.asarray(jnp.argmax(lw, -1)).astype(np.int32)[:, None]
        lw, cw = decode_ref(params, cw, {"tokens": jnp.asarray(tk),
                                         "t": jnp.int32(t0 + i)})
        lg, cg = decode(pt, cg, {"tokens": tk, "t": np.int32(t0 + i)})
        _close(lg.numpy(), lw, f"decode step {i}")
    caches_close("decode")


_GUARD = """
    import importlib
    import importlib.abc
    import importlib.util
    import pkgutil
    import sys
    from pathlib import Path

    BLOCKED = ("jax", "jaxlib", "repro")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    # the mesh's modules among them
    assert {"repro_torch.launch.mesh", "repro_torch.launch.preboot",
            "repro_torch.sharding", "repro_torch.sharding.rules"} <= set(names)
    for name in names:
        importlib.import_module(name)
    root = Path(sys.argv[1])
    files = sorted(root.glob("examples/*_torch.py")) + [root /
                                                        "chip_smoke.py"]
    for f in files:
        spec = importlib.util.spec_from_file_location(f.stem, f)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not bad, bad
    print(len(names), len(files))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_GUARD),
                          str(ROOT)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, n_files = map(int, out.stdout.split())
    assert n_modules > 40 and n_files >= 4
