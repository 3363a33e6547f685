"""The port's serving CLI against the reference's on the launcher's
windowed case, ``--config gemma2-27b --reduced --prefill-chunk 16
--paged --kv-clusters 8``: the reduced gemma2-27b's 'L' layers under
WindowRetention beside its clustered 'G' layers.  Every printed line
equal but for its timing fields, the port on the CPU serving the
reference's weights, the reduced config in f32 (the other cases are in
tests/test_torch_serve_cli.py and tests/test_torch_serve_cli_paged.py)."""

from _torch_ref import exact_pow2_reference  # noqa: F401  (fixture)
from _torch_serve_cli import (BASE, PAGED, assert_lines_equal,  # noqa: F401
                              f32_reduced, run_port, run_reference)


def test_cli_windowed_lines_equal_reference(f32_reduced, capsys,
                                            monkeypatch):
    argv = (["--config", "gemma2-27b", "--reduced"] + BASE + PAGED
            + ["--kv-clusters", "8"])
    want = run_reference(argv, capsys, monkeypatch)
    got, srv = run_port(argv)
    assert_lines_equal(got, want)
    assert any(g.startswith("[serve] windowed model: ") for g in got)
    st = srv.last_stats
    assert st["kv_retired_window"] > 0
    assert st["pool_allocs"] == st["pool_frees"]
