"""Shared pieces of the serving-CLI parity tests
(tests/test_torch_serve_cli*.py): run ``repro.launch.serve.main`` with
``sys.argv`` patched and its stdout captured, and the port's
``repro_torch.launch.serve.main`` on the CPU with the reference's weights
bridged from ``PRNGKey(seed)``; both packages' ``configs.get_reduced``
patched to f32, the reference's ``auto_scale`` to exact powers of two
(``_torch_ref``).  Lines are compared with only the timing fields masked:
seconds, tok/s and ms."""

import dataclasses
import sys

import jax
import numpy as np
import pytest

from repro import configs as configs_ref
from repro_torch import bridge
from repro_torch import configs as configs_t

from _serve_lines import mask  # noqa: F401  (re-exported)
from _torch_ref import exact_pow2_reference, ref_init_params  # noqa: F401

BASE = ["--requests", "8", "--max-new", "4"]
QWEN = ["--arch", "qwen3-4b", "--reduced"]
PAGED = ["--paged", "--prefill-chunk", "16"]


@pytest.fixture
def f32_reduced(monkeypatch, exact_pow2_reference):  # noqa: F811
    """Both packages' reduced configs in f32; the reference's auto_scale
    exact."""
    for mod in (configs_ref, configs_t):
        orig = mod.get_reduced
        monkeypatch.setattr(
            mod, "get_reduced",
            lambda a, orig=orig: dataclasses.replace(orig(a),
                                                     dtype="float32"))
    yield


def run_reference(argv, capsys, monkeypatch):
    """The reference launcher's stdout lines for ``argv``."""
    from repro.launch import serve as serve_ref

    monkeypatch.setattr(sys, "argv", ["serve"] + list(argv))
    capsys.readouterr()
    serve_ref.main()
    return capsys.readouterr().out.splitlines()


def arch_of(argv) -> str:
    return argv[argv.index("--arch" if "--arch" in argv else "--config") + 1]


def run_port(argv, seed: int = 0):
    """The port's lines for ``argv`` + ``--device cpu``, serving the
    reference's weights of the (patched) reduced config; (lines,
    Server)."""
    from repro_torch.launch import serve as serve_t

    arch = arch_of(argv)
    params = bridge.params_from_numpy(
        jax.tree.map(np.asarray,
                     ref_init_params(configs_ref.get_reduced(arch), seed)),
        configs_t.get_reduced(arch), "cpu")
    got = []
    srv = serve_t.main(list(argv) + ["--device", "cpu"], params=params,
                       say=got.append)
    return got, srv


def assert_lines_equal(got, want):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert mask(g) == mask(w)
