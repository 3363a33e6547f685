"""The port's serving CLI (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``) on the reduced qwen3-4b in f32, the
port on the CPU serving the reference's weights: every printed line equal
but for its timing fields, for exact KV in blocking mode, blocking
clustered KV, and the paged SLO scheduler traced (the trace's event names
and counts equal too).  The paged template-store and prefix-sharing
cases are in tests/test_torch_serve_cli_paged.py, the windowed one in
tests/test_torch_serve_cli_window.py.  Also the
error paths (``--priority-demo`` without ``--paged``, a chunked serve of
a model the engine cannot serve chunked, ``--mesh`` without a world),
the flags (the reference's help plus ``--device``) and an unpatched run
at the config's own bf16."""

import collections
import json
import sys

import pytest
import torch

from repro_torch.launch import serve as serve_t

from _torch_ref import exact_pow2_reference  # noqa: F401  (fixture)
from _torch_serve_cli import (BASE, QWEN, assert_lines_equal,  # noqa: F401
                              f32_reduced, run_port, run_reference)


@pytest.mark.parametrize("flags", [
    [],
    ["--kv-clusters", "8", "--keep-recent", "16", "--refresh-every", "8"],
], ids=["exact", "clustered"])
def test_cli_lines_equal_reference(flags, f32_reduced, capsys, monkeypatch):
    argv = QWEN + BASE + flags
    want = run_reference(argv, capsys, monkeypatch)
    got, srv = run_port(argv)
    assert_lines_equal(got, want)
    assert any(g.startswith("[serve] 8 completions, 32 tokens in ")
               for g in got)
    assert srv.device.type == "cpu"


def _trace_names(path):
    events = json.loads(path.read_text())["traceEvents"]
    return collections.Counter(e["name"] for e in events)


def test_cli_priority_demo_traced_equals_reference(f32_reduced, capsys,
                                                   monkeypatch, tmp_path):
    flags = ["--paged", "--prefill-chunk", "16", "--priority-demo",
             "--trace-out"]
    ref_path, port_path = tmp_path / "ref.json", tmp_path / "port.json"
    want = run_reference(QWEN + BASE + flags + [str(ref_path)], capsys,
                         monkeypatch)
    got, srv = run_port(QWEN + BASE + flags + [str(port_path)])
    assert_lines_equal([g.replace(str(port_path), "<trace>") for g in got],
                       [w.replace(str(ref_path), "<trace>") for w in want])
    assert any(g.startswith("[serve] SLO scheduling: ") for g in got)
    assert _trace_names(port_path) == _trace_names(ref_path)
    st = srv.last_stats
    assert st["sched_shed_high"] == 0 and st["pool_blocks_end"] == 0


def _error(main, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        main()
    return exc.value.code, capsys.readouterr().err.splitlines()[-1]


@pytest.mark.parametrize("argv", [
    QWEN + BASE + ["--priority-demo"],
    ["--arch", "deepseek-v3-671b", "--reduced", "--paged"],
    ["--arch", "seamless-m4t-medium", "--reduced", "--prefill-chunk", "16"],
], ids=["priority-demo-unpaged", "mla-paged", "encdec-chunked"])
def test_cli_refusals_equal_reference(argv, f32_reduced, capsys,
                                      monkeypatch):
    """Exit 2 with the reference's message, word for word."""
    from repro.launch import serve as serve_ref

    want = _error(serve_ref.main, argv, capsys, monkeypatch)
    got = _error(lambda: serve_t.main(argv + ["--device", "cpu"]), argv,
                 capsys, monkeypatch)
    assert got == want
    assert want[0] == 2 and want[1].startswith("serve: error: ")


def test_cli_refuses_mesh(capsys, monkeypatch):
    """``main`` called in a process that is no rank of a world refuses a
    mesh, naming the ranks it needs (run as ``python -m``, the launcher
    starts them: tests/test_torch_serve_cli_mesh.py)."""
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    code, msg = _error(lambda: serve_t.main(QWEN + ["--mesh", "2x4",
                                                    "--device", "cpu"]),
                       [], capsys, monkeypatch)
    assert code == 2
    assert "--mesh 2x4" in msg and "world of 8 ranks" in msg


def _options_section(main, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", "--help"])
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        main()
    assert exc.value.code == 0
    return capsys.readouterr().out.split("options:\n", 1)[1].splitlines()


def test_cli_flags_are_the_reference_flags_plus_device(capsys, monkeypatch):
    """The port's --help lists the reference's options with their help
    text, defaults and choices unchanged, plus --device."""
    from repro.launch import serve as serve_ref

    want = _options_section(serve_ref.main, capsys, monkeypatch)
    got = _options_section(lambda: serve_t.main(), capsys, monkeypatch)
    i = next(i for i, line in enumerate(got)
             if line.startswith("  --device"))
    j = next((j for j in range(i + 1, len(got))
              if got[j].startswith("  -")), len(got))
    assert got[:i] + got[j:] == want
    opts = {a.dest: a for a in serve_t.parser()._actions}
    assert opts["device"].default == "cuda"
    assert opts["arch"].option_strings == ["--arch", "--config"]


def test_cli_runs_at_the_configs_own_dtype():
    """Unpatched: ``--reduced --device cpu`` serves the reduced qwen3-4b
    in its bf16, drawing its own weights."""
    got = []
    srv = serve_t.main(QWEN + ["--requests", "4", "--max-new", "2",
                               "--device", "cpu"], say=got.append)
    assert srv.cfg.dtype == "bfloat16"
    assert srv.params["embed"]["table"].dtype == torch.bfloat16
    assert got[1].startswith("[serve] 4 completions, 8 tokens in ")


def test_cli_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_t.main(QWEN + ["--requests", "1"])
