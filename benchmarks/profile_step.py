"""Microbenchmark: where does a tracer step spend its time on the GPU?

Times, at the default wavefront width (engine.api.AUTO_LANES):
  emit      device emission of a full wavefront (regen refill cost bound)
  draw8     the 8 per-step threefry uniforms
  physics   one full physics_core step via the fast XLA step_fn
  loopstep  amortised per-iteration cost of the real regen while_loop

Needs a GPU.

Run:  python benchmarks/profile_step.py [n_photons]
      python benchmarks/profile_step.py trace   # jax.profiler trace to profiles/
"""
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")
from bench import build_scene, gpu_device  # noqa: E402

from pvtrace_tpu.engine import compiler as comp  # noqa: E402
from pvtrace_tpu.engine import tracer as tr  # noqa: E402
from pvtrace_tpu.engine.api import AUTO_LANES  # noqa: E402


def timeit(fn, *args, reps=20):
    from pvtrace_tpu.utils.profiling import Timer

    out = fn(*args)
    jax.block_until_ready(out)
    with Timer() as t:
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
    return t.elapsed / reps


def main():
    print(f"device: {gpu_device()}")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8_000_000
    lanes = AUTO_LANES
    scene = build_scene()
    compiled = comp.compile_scene(scene)
    cfg = tr.make_config(compiled, n, record_every=0)
    tables = compiled.device_tables(cfg.dtype)
    base_key = jax.random.PRNGKey(7)

    pid, keys = tr._photon_keys(base_key, lanes, 0)

    emit = jax.jit(
        lambda k0, k1, p: tr._device_emit(compiled, cfg, tables, (k0, k1), p)
    )
    t_emit = timeit(emit, keys[0], keys[1], pid)

    cnt = jnp.ones(lanes, jnp.uint32)
    draw = jax.jit(lambda k0, k1, c: tr._draw8(k0, k1, c, cfg.dtype))
    t_draw = timeit(draw, keys[0], keys[1], cnt)

    # full regen loop, amortised
    total = jnp.uint32(n)
    run = jax.jit(
        lambda k0, k1, p, p3, d3, w: tr._run(
            compiled, cfg, tables, p, (k0, k1), p3, d3, w,
            regen=(base_key, total),
        )
    )
    pos3, dir3, wav = emit(keys[0], keys[1], pid)
    out = run(keys[0], keys[1], pid, pos3, dir3, wav)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = run(keys[0], keys[1], pid, pos3, dir3, wav)
    jax.block_until_ready(out)
    t_loop = time.perf_counter() - t0
    steps = int(out[3])

    print(f"lanes={lanes} photons={n} loop_steps={steps}")
    print(f"emit      {t_emit*1e3:8.3f} ms/call")
    print(f"draw8     {t_draw*1e3:8.3f} ms/call")
    print(f"loop      {t_loop*1e3:8.1f} ms total -> {t_loop/steps*1e3:8.3f} ms/step")
    print(f"throughput {n/t_loop/1e6:.2f} M photons/s")


def capture_trace(outdir="profiles"):
    print(f"device: {gpu_device()}")
    n = 8_000_000
    lanes = AUTO_LANES
    scene = build_scene()
    compiled = comp.compile_scene(scene)
    cfg = tr.make_config(compiled, n, record_every=0)
    tables = compiled.device_tables(cfg.dtype)
    base_key = jax.random.PRNGKey(7)
    pid, keys = tr._photon_keys(base_key, lanes, 0)
    emit = jax.jit(
        lambda k0, k1, p: tr._device_emit(compiled, cfg, tables, (k0, k1), p)
    )
    pos3, dir3, wav = emit(keys[0], keys[1], pid)
    total = jnp.uint32(n)
    run = jax.jit(
        lambda k0, k1, p, p3, d3, w: tr._run(
            compiled, cfg, tables, p, (k0, k1), p3, d3, w,
            regen=(base_key, total),
        )
    )
    out = run(keys[0], keys[1], pid, pos3, dir3, wav)
    jax.block_until_ready(out)
    from pvtrace_tpu.utils.profiling import trace_profile

    with trace_profile(outdir):
        out = run(keys[0], keys[1], pid, pos3, dir3, wav)
        jax.block_until_ready(out)
    print("trace written to", outdir)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "trace":
        capture_trace()
    else:
        main()
