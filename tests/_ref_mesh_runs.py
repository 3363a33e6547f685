"""The reference's own mesh serves of the runtime-mode pins, for
tests/test_torch_sharded_prefix.py and tests/test_torch_sharded_slo.py to
hold the port's (data=2, model=4) gloo world against: the same streams
(``_torch_runtime_ranks``), the same ServerConfigs and weights
(``ref_init_params``, ``auto_scale`` patched to exact powers of two), on
a 2 x 4 mesh of 8 fake XLA host devices.

``start(which)`` runs ``python _ref_mesh_runs.py which`` in a child
process with ``XLA_FLAGS`` forcing 8 host devices (the test process keeps
one device); ``result(proc)`` reads the one JSON line it prints: each
serve's tokens, shed flags, counters and, for the traced SLO serves, the
``swap_out`` / ``resume`` / ``shed`` events as the port's ranks report
them (``_torch_runtime_ranks.swap_events``).
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def start(which: str) -> subprocess.Popen:
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([SRC, HERE]))
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), which],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def result(proc: subprocess.Popen, timeout: float = 400.0) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-6000:]
    return json.loads(out.strip().splitlines()[-1])


def _serves():
    """Run in the child: {name: (tokens, shed, stats[, events])}."""
    import types

    import jax
    import numpy as np

    from repro.core import kv_compress, quantizer
    from repro.core.request_cluster import Request
    from repro.launch.mesh import make_serving_mesh
    from repro.models.config import ModelConfig, SSMConfig
    from repro.runtime.kv_pool import PagedKVConfig
    from repro.runtime.prefix_cache import PrefixShareConfig
    from repro.runtime.scheduler import SLOConfig
    from repro.runtime.server import Server, ServerConfig
    from repro.runtime.telemetry import TelemetryConfig
    from repro.runtime.template_store import TemplateStoreConfig

    import _torch_ref
    import _torch_runtime_ranks as ranks

    assert len(jax.devices()) == 8
    quantizer.auto_scale = _torch_ref._auto_scale_exact
    ns = types.SimpleNamespace(
        ServerConfig=ServerConfig,
        KVCompressConfig=kv_compress.KVCompressConfig,
        PagedKVConfig=PagedKVConfig, PrefixShareConfig=PrefixShareConfig,
        TemplateStoreConfig=TemplateStoreConfig, SLOConfig=SLOConfig,
        TelemetryConfig=TelemetryConfig)
    mesh = make_serving_mesh("2x4")

    def serve(srv, stream, keys, traced=False):
        outs = srv.serve(*stream)
        got = [{o.uid: list(map(int, o.tokens)) for o in outs},
               {o.uid: bool(o.shed) for o in outs},
               {k: srv.last_stats.get(k) for k in keys}]
        if traced:
            got.append(ranks.swap_events(srv.last_trace))
        return got

    def model(name):
        cfg = ranks.config(name, ModelConfig, SSMConfig)
        return cfg, jax.tree.map(np.asarray,
                                 _torch_ref.ref_init_params(cfg, 0))

    which = sys.argv[1]
    out = {}
    if which == "prefix":
        cfg, params = model("G")
        srv = Server(cfg, ranks.server_config(ns, share=True, mesh=mesh),
                     params)
        out["shared"] = serve(srv, ranks.templated_stream(Request),
                              ranks.PREFIX_STATS)
        srv = Server(cfg, ranks.server_config(ns, pool=24, store=True,
                                              mesh=mesh), params)
        out["warm1"] = serve(srv, ranks.store_burst(11, Request),
                             ranks.PREFIX_STATS)
        out["warm2"] = serve(srv, ranks.store_burst(13, Request),
                             ranks.PREFIX_STATS)
    else:
        for name in ("G", "GM", "GR"):
            cfg, params = model(name)
            srv = Server(cfg, ranks.server_config(
                ns, pool=8, slo=True, fifo=True, trace=True, mesh=mesh),
                params)
            out[name] = serve(srv, ranks.slo_stream(Request),
                              ranks.SLO_STATS, traced=True)
    return out


if __name__ == "__main__":
    print(json.dumps(_serves()))
