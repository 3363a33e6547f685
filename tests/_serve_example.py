"""examples/serve_clustered_kv_torch.py and the reference example it
twins, for the parity tests: the twin runs on the CPU with the
reference's weights (bridged from PRNGKey 0, 1 and 2 for SMALL, GLWIN and
GMREC), the reference with its ``auto_scale`` patched to exact powers of
two (``_torch_ref``); both give their printed lines with the timing
fields masked."""

import contextlib
import dataclasses
import io
import runpy
from pathlib import Path

import jax
import numpy as np

from repro.models import config as config_ref
from repro_torch import bridge

from _serve_lines import mask
from _torch_ref import _auto_scale_exact, ref_init_params

ROOT = Path(__file__).resolve().parents[1]


def _ref_config(cfg):
    """The reference's ModelConfig with the port config's fields."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if kw.get("ssm") is not None:
        kw["ssm"] = config_ref.SSMConfig(**dataclasses.asdict(kw["ssm"]))
    return config_ref.ModelConfig(**kw)


def run_twin():
    """(masked lines, ``run``'s result) of the twin on the CPU serving the
    reference's weights."""
    twin = runpy.run_path(
        str(ROOT / "examples" / "serve_clustered_kv_torch.py"),
        run_name="serve_clustered_kv_torch")
    params = {
        name: bridge.params_from_numpy(
            jax.tree.map(np.asarray,
                         ref_init_params(_ref_config(twin[name]), seed)),
            twin[name], "cpu")
        for name, seed in twin["SEEDS"].items()}
    got = []
    out = twin["run"]("cpu", say=got.append, params=params)
    return [mask(line) for line in got], out


def capture_reference():
    """The reference example's masked lines, auto_scale exact (minutes on
    a CPU).  Patches ``quantizer.auto_scale`` for the rest of the process,
    so run it in a process of its own."""
    from repro.core import quantizer

    quantizer.auto_scale = _auto_scale_exact
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(ROOT / "examples" / "serve_clustered_kv.py"),
                       run_name="__main__")
    return [mask(line) for line in buf.getvalue().splitlines()]
