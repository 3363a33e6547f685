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

``start("train", out, *cases)`` runs the training cases of
``_torch_train_ranks.CASES`` instead: each case's own 8-device mesh
step (``lower_step(...).compile()``) for ``STEPS`` steps from
``init_params(PRNGKey(0))`` (its router skewed where the case says), and
pickles to ``out`` every step's loss and gradient norm, the last
metrics, and the parameters and both moments after the last step
(numpy trees).
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def start(which: str, *args) -> subprocess.Popen:
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([SRC, HERE]))
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), which,
                             *args],
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


def _train(out_path: str, cases):
    """Run in the child: the reference's own mesh training steps of
    ``cases`` (``_torch_train_ranks``), pickled to ``out_path``."""
    import pickle

    import jax
    import numpy as np

    from repro import configs
    from repro.core import grad_compress
    from repro.data import pipeline
    from repro.launch import steps
    from repro.launch.mesh import _mesh
    from repro.models.config import ShapeCell
    from repro.optim import adamw

    import _torch_ref
    import _torch_train_ranks as tr

    assert len(jax.devices()) == 8
    out = {}
    for name in cases:
        c = tr.case(name)
        cfg = tr.config(name, configs.get_reduced)
        mesh = _mesh(tuple(c["mesh"].values()), tuple(c["mesh"]))
        cell = ShapeCell("t", tr.SEQ, c["batch"], "train")
        opts = steps.pick_options(cfg, mesh, cell, **c["overrides"])
        aw = adamw.AdamWConfig(**tr.AW)
        gt = (grad_compress.make_grad_transform(
            grad_compress.CompressConfig(), axis_name="pod")
            if c["grad_compress"] else None)
        lowered, info = steps.lower_step(cfg, mesh, cell, opts, aw, gt)
        fn = lowered.compile()
        p = jax.tree.map(np.asarray, _torch_ref.ref_init_params(cfg))
        if c["skew"]:
            p = tr.skew_router(p)
        o = adamw.init(p)
        data = pipeline.SyntheticLM(cfg, pipeline.DataConfig(
            seed=0, global_batch=c["batch"], seq_len=tr.SEQ))
        losses, norms = [], []
        for s in range(tr.STEPS):
            p, o, m = fn(p, o, data.batch_at(s))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[name] = {"losses": losses, "norms": norms,
                     "options": info["options"],
                     "metrics": {k: float(v) for k, v in m.items()},
                     "tree": [jax.tree.map(np.asarray, t)
                              for t in (p, o.m, o.v)]}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return {"cases": list(out)}


if __name__ == "__main__":
    if sys.argv[1] == "train":
        print(json.dumps(_train(sys.argv[2], sys.argv[3:])))
    else:
        print(json.dumps(_serves()))
