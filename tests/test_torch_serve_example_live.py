"""examples/serve_clustered_kv_torch.py against the reference example
run in the same test: the reference (examples/serve_clustered_kv.py,
``auto_scale`` patched to exact powers of two, PRNGKey 0, 1 and 2) runs in
a process of its own while the twin serves the same weights, bridged, on
the CPU in this one; every printed line equal with only the timing fields
(s, tok/s, ms) masked, the ``[kv]`` rel-err to its printed three digits
included.  The reference takes minutes on a CPU, the twin well under one;
they overlap."""

import json
import os
import subprocess
import sys

from _serve_example import ROOT, run_twin

CAPTURE = ("import json, _serve_example as s; "
           "print(json.dumps(s.capture_reference()))")


def test_example_twin_prints_the_live_reference_lines():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    ref = subprocess.Popen([sys.executable, "-c", CAPTURE], cwd=ROOT,
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        got, out = run_twin()
        stdout, stderr = ref.communicate(timeout=1200)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, stderr[-4000:]
    want = json.loads(stdout.splitlines()[-1])
    assert want and want[-1].startswith("[kv] ")
    assert got == want
    assert f"rel-err {out['rel_err']:.3f}" in want[-1]
