"""examples/serve_clustered_kv_torch.py on the CPU against a golden of
the reference example's output: the twin serves the reference's weights
(bridged from PRNGKey 0, 1 and 2 for SMALL, GLWIN and GMREC) and every
printed line equals the golden below with only the timing fields (tok/s,
ms) masked; its invariant lines all read "identical", its pools drain.
The ``[kv]`` rel-err equals the golden's to the printed three digits.

``GOLDEN`` is a quick check that fails in seconds; the gate is
``tests/test_torch_serve_example_live.py``, which runs the reference
example itself (minutes on a CPU) beside the twin.  ``GOLDEN`` is
examples/serve_clustered_kv.py's output with the reference's
``auto_scale`` patched to exact powers of two (``_torch_ref``), masked;
re-capture it with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_serve_example.py

which prints the literal to paste here."""

from _serve_example import capture_reference, run_twin

GOLDEN = [
    '[batcher] padding waste: fifo 40.9% → clustered 14.0%',
    '[server] continuous batching: 24 completions, <t> tok/s, slot waste 0.0%',
    '[server] chunked prefill (--prefill-chunk 16): <t> tok/s wall, TTFT p50/p95 <t> ms, 136 chunks, tokens identical vs blocking admission',
    '[server] bucketed launches: mean bucket 3.86 slots/shard (96% of slots launched per step; the drain tail stops paying for empty slots)',
    '[server] clustered-KV + compaction (+chunked admission, 62 absorbs): <t> tok/s, token agreement vs exact serving 100%',
    '[server] paged KV (8-pos blocks): tokens identical vs dense clustered; launch padding 42% vs dense 75%, pool peak 88% of 16 blocks (281 allocs / 281 frees, 0 still held at drain)',
    '[server] prefix sharing (96-token template x 12 requests): tokens identical vs unshared paged; 11 hits reused 1056 prompt tokens, TTFT p95 <t> ms, 192 KiB of tail KV shared, 0 copy-on-write swaps (physical peak 512 vs 256 KiB/shard — faster admission keeps more requests in flight)',
    '[server] template store (persistent across serves): warm serve TTFT p95 <t> ms vs <t> ms for the store-filling serve, 12 warm hits reused 1152 prompt tokens, tokens identical vs a cold store',
    '[server] store state: 2 entries pinning 4 blocks between serves (128 KiB), 1 traffic clusters, cohesion 0.92',
    '[server] SLO scheduling (pool 10/16 blocks, 6 priority-1 at the tail): 2 preemptions, 2 swap-ins, 6 deferrals, 0 best-effort shed (0 protected shed); priority-1 TTFT p95 <t> ms; non-shed tokens identical vs the unpressured paged serve',
    '[telemetry] traced serve: 466 events (absorb, brownout, engine_step, finish, first_token, prefill_chunk, queued, resume, run, state_families, swap_out), schema problems: 0, tokens identical vs the untraced serve',
    '[telemetry] phase breakdown: absorb <t> ms, decode <t> ms, mixed <t> ms, prefill <t> ms, resume <t> ms, swap_out <t> ms',
    '[telemetry] metrics reference (47 metrics; first rows):',
    '    | metric | type | description |',
    '    |---|---|---|',
    '    | `decode_steps` | counter | engine launches this serve |',
    '    | `slot_waste` | gauge | idle slot-steps / total slot-steps |',
    '    | `prefill_pad_frac` | gauge | prompt pad tokens / all prefill tokens |',
    '    | `gen_tokens` | counter | tokens generated this serve |',
    "[server] sliding-window model ('GL' x2, window=16, chunked + paged): tokens identical vs blocking dense; window retired 132 positions, frontier retired 2, 0 blocks held at drain",
    "[server] hybrid recurrent model ('GM', chunked + paged): tokens identical vs blocking decode; state bytes/slot ring 2116 / recurrent 10112, recurrent retired 0 (fixed-size state never retires), 0 blocks at drain",
    '[server] mesh serving skipped (1 device; set XLA_FLAGS=--xla_force_host_platform_device_count=8 to try a 2x4 mesh)',
    '[kv] 192 keys → 24 median centroids + 32 exact tail: memory 3.4× smaller, attention rel-err 0.132',
]


def test_example_twin_prints_the_reference_lines():
    got, out = run_twin()
    assert got == GOLDEN
    assert not any("DIVERGED" in line for line in got)
    assert sum("identical" in line for line in got) == 8
    assert set(out["pool_blocks_end"].values()) == {0.0}
    assert out["schema_problems"] == 0 and out["protected_shed"] == 0
    assert f"rel-err {out['rel_err']:.3f}" in GOLDEN[-1]


if __name__ == "__main__":
    print("GOLDEN = [\n" + "".join(f"    {line!r},\n"
                                    for line in capture_reference()) + "]")
