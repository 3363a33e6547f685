"""The port's serving CLI against the reference's, paged and chunked on
the reduced qwen3-4b (the rest is in tests/test_torch_serve_cli.py and
tests/test_torch_serve_cli_window.py): the template store served twice
(the warm re-serve's tokens identical, the pool drained by
``invalidate_templates()``) and prefix sharing.  Every printed line equal
but for its timing fields, the port on the CPU serving the reference's
weights, reduced configs in f32."""

import pytest

from _torch_ref import exact_pow2_reference  # noqa: F401  (fixture)
from _torch_serve_cli import (BASE, PAGED, QWEN,  # noqa: F401
                              assert_lines_equal, f32_reduced, run_port,
                              run_reference)


@pytest.mark.parametrize("argv", [
    QWEN + BASE + PAGED + ["--persist-templates"],
    QWEN + BASE + PAGED + ["--prefix-share"],
], ids=["persist-templates", "prefix-share"])
def test_cli_paged_lines_equal_reference(argv, f32_reduced, capsys,
                                         monkeypatch):
    want = run_reference(argv, capsys, monkeypatch)
    got, srv = run_port(argv)
    assert_lines_equal(got, want)
    st = srv.last_stats
    assert st["pool_allocs"] == st["pool_frees"]
    if "--persist-templates" in argv:
        assert any(g.startswith("[serve] warm re-serve: ")
                   and g.endswith("tokens identical: True") for g in got)
        assert st["prefix_hits"] > 0
        assert srv._tmpl_pool is None        # invalidate_templates() ran
    else:
        assert any(g.startswith("[serve] prefix sharing: ") for g in got)
