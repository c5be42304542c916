"""Multi-device photon-batch sharding.

The reference parallelises with one OS process per CPU worker and a
per-worker reseed (``scene/scene.py:256-313``). Here the *photon axis*
is sharded over every device of a 1-D mesh with ``shard_map``:

* scene tables are tiny (<100 kB) and replicated to every device;
* each device traces its photon slice with the same wavefront program;
* every tally accumulator — recorder histograms / counters / moment
  sums, and with ``cfg.score`` the fate/recorder score-function
  gradient sums — is reduced with ``psum`` across the devices, the
  analogue of the reference's per-thread accumulator merge
  (``_kernel.pyx:1019-1032``) plus the gradient all-reduce SURVEY §2.3
  mandates for the differentiable path;
* per-photon RNG keys are folded from the *global* photon index, so
  results are bitwise independent of the sharding layout — the same
  guarantee as the reference's seed-per-ray streams.

Multi-host: call ``parallel.init_distributed()`` on every host, build
the mesh with ``parallel.global_photon_mesh()`` and use these same
entry points — the compiled program is identical (collectives only);
the wrappers lift each process's host-local inputs to global arrays
and localise the replicated outputs. ``tests/test_multihost.py``
asserts 2-process tallies are bitwise equal to the single-process run.
"""
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from pvtrace_tpu.engine import tracer as tracer_module
from pvtrace_tpu.engine.api import AUTO_LANES, _enable_persistent_cache
from pvtrace_tpu.parallel import distributed

#: Compiled sharded tracers, keyed on (path, scene digest, cfg, mesh,
#: axis, lanes). Bundle loops (streamed gradient runs at 1e8 photons)
#: re-enter these builders once per bundle; without the cache every
#: bundle would recompile the shard_map program.
_SHARD_CACHE = {}


def make_photon_mesh(devices=None, axis_name="photons"):
    """A 1D device mesh over the photon batch axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def _psum_all(tallies, axis_name):
    """psum-reduce every tally accumulator across the mesh.

    The tracer returns only additive tallies (integer counters, float
    moment sums, and — when ``cfg.score`` — the ``fate_scores``/
    ``rec_scores`` score-function gradient accumulators; per-lane loop
    state stays behind), so the reduction is a uniform tree_map.
    """
    return jax.tree_util.tree_map(
        lambda x: jax.lax.psum(x, axis_name), tallies
    )


def shard_trace(compiled, cfg, mesh, axis_name="photons"):
    """Build a jitted multi-chip trace function.

    Returns fn(tables, positions, directions, wavelengths, base_key,
    index_offset=0) -> (tallies, steps) where every tally accumulator
    (including the score gradients when ``cfg.score``) is already
    psum-reduced across the mesh. ``index_offset`` is the global photon
    id of the bundle's first photon (for exact-union streamed bundles,
    same semantics as ``engine.simulate``). Event histories are not
    recorded on the sharded path (use single-device tracing for
    debugging histories).
    """
    if cfg.n_slots != 0:
        raise ValueError(
            "shard_trace requires record_every=0 (tallies only); "
            "use engine.simulate for histories."
        )
    cache_key = ("host", compiled.content_digest, cfg, mesh, axis_name)
    cached = _SHARD_CACHE.get(cache_key)
    if cached is not None:
        return cached
    _enable_persistent_cache()
    n_dev = mesh.devices.size

    def per_shard(tables, pos, direction, wav, base_key, offset):
        # Global photon index = bundle offset + shard offset + local
        # index, so keys are identical to the single-device run.
        shard = jax.lax.axis_index(axis_name)
        local_b = pos.shape[0]
        off = offset[0] + (shard * local_b).astype(jnp.uint32)
        tallies, _log, _counts, steps = tracer_module.trace_bundle(
            compiled, cfg, tables, pos, direction, wav, base_key,
            index_offset=off,
        )
        return _psum_all(tallies, axis_name), jax.lax.pmax(steps, axis_name)

    fn = jax.jit(
        jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(), P(axis_name), P(axis_name), P(axis_name), P(), P()),
            out_specs=(P(), P()),
            # The tracer builds fresh (unvarying) carries inside the
            # shard; skip the varying-manual-axes analysis.
            check_vma=False,
        )
    )

    def traced(tables, positions, directions, wavelengths, base_key,
               index_offset=0):
        # Multi-process: each process passes ITS slice of the photon
        # batch; the global batch is the concatenation over processes.
        B = positions.shape[0] * jax.process_count()
        if B % n_dev != 0:
            raise ValueError(
                f"Photon batch ({B}) must be a multiple of the mesh size ({n_dev})."
            )
        offset = np.asarray([index_offset], dtype=np.uint32)
        args = distributed.globalize(
            mesh,
            (tables, positions, directions, wavelengths, base_key, offset),
            (P(), P(axis_name), P(axis_name), P(axis_name), P(), P()),
        )
        out = fn(*args)
        return distributed.localize(mesh, out, (P(), P()))

    _SHARD_CACHE[cache_key] = traced
    return traced


def shard_trace_device_emit(compiled, cfg, mesh, lanes=None,
                            axis_name="photons"):
    """Multi-chip tracing with device-side emission and regeneration.

    Returns fn(tables, n_rays, base_key, index_offset=0) ->
    (tallies, steps). The photon budget is split evenly over the mesh;
    each shard emits its photons on device from its own global-id range
    (no host bundle, no transfer) and, when ``lanes`` is set, refills
    dead lanes until its budget is spent. Keys fold the global photon
    index, so the union of shard results equals a single-device run
    over the same ids; every accumulator (score gradients included) is
    psum-reduced.

    `n_rays` is traced (one compile serves any budget); it must be a
    multiple of the mesh size, and each shard's share must exceed
    `lanes` for regeneration to engage.
    """
    if cfg.n_slots != 0:
        raise ValueError(
            "shard_trace_device_emit requires record_every=0 "
            "(tallies only)."
        )
    if not compiled.lights_supported:
        raise ValueError(
            "Scene lights are not supported for device-side emission."
        )
    cache_key = (
        "device", compiled.content_digest, cfg, mesh, axis_name, lanes
    )
    cached = _SHARD_CACHE.get(cache_key)
    if cached is not None:
        return cached
    _enable_persistent_cache()
    n_dev = mesh.devices.size
    # Without regeneration the wavefront width IS the per-shard photon
    # count, which must therefore be a compile-time constant; with
    # regeneration the budget only appears in comparisons, so ONE
    # dynamic program serves any budget. `fns[None]` is the dynamic
    # program; `fns[n]` the static-width program for n photons/shard.
    fns = {}

    def get_fn(n_static):
        fn = fns.get(n_static)
        if fn is not None:
            return fn

        def per_shard(tables, n_per_shard, base_key, offset):
            shard = jax.lax.axis_index(axis_name)
            if n_static is None:
                n_local = n_per_shard[0]
                off = offset[0] + (
                    shard.astype(jnp.uint32) * n_local.astype(jnp.uint32)
                )
            else:
                n_local = n_static
                off = offset[0] + (
                    shard.astype(jnp.uint32) * jnp.uint32(n_static)
                )
            tallies, _log, _counts, steps = (
                tracer_module.trace_bundle_device_emit(
                    compiled, cfg, tables, base_key, n_local,
                    index_offset=off,
                    lanes=lanes if n_static is None else None,
                )
            )
            return (
                _psum_all(tallies, axis_name),
                jax.lax.pmax(steps, axis_name),
            )

        fn = jax.jit(
            jax.shard_map(
                per_shard,
                mesh=mesh,
                in_specs=(P(), P(), P(), P()),
                out_specs=(P(), P()),
                check_vma=False,
            )
        )
        fns[n_static] = fn
        return fn

    def traced(tables, n_rays, base_key, index_offset=0):
        # `n_rays` is the GLOBAL photon budget on every process.
        if int(n_rays) % n_dev != 0:
            raise ValueError(
                f"n_rays ({n_rays}) must be a multiple of the mesh size ({n_dev})."
            )
        n_per_int = int(n_rays) // n_dev
        if lanes is not None and lanes < n_per_int:
            fn = get_fn(None)  # regeneration: dynamic budget
        else:
            fn = get_fn(n_per_int)  # full-width: static wavefront
        n_per = np.full((1,), n_per_int, np.uint32)
        offset = np.asarray([index_offset], dtype=np.uint32)
        args = distributed.globalize(
            mesh, (tables, n_per, base_key, offset), (P(), P(), P(), P())
        )
        out = fn(*args)
        return distributed.localize(mesh, out, (P(), P()))

    _SHARD_CACHE[cache_key] = traced
    return traced


def shard_simulate(scene, num_rays, mesh, seed=None, maxsteps=1000,
                   maxpathlength=None, max_events=128, emit_method="kT",
                   dtype=None, compiled=None, lanes="auto", score=False,
                   pathwise=(), index_offset=0, axis_name="photons",
                   workers=None, record_every=0):
    """Sharded analogue of ``engine.simulate`` (tallies only).

    Traces `num_rays` with the photon axis sharded over `mesh` and
    every tally accumulator psum-reduced, returning the same data keys
    as ``engine.simulate(record_every=0)``: ``rec_distinct``,
    ``rec_crossings``, ``rec_sums``, ``rec_bins``, ``fates``, ``steps``
    and — with ``score=True`` — ``fate_scores`` / ``rec_scores`` (the
    unbiased score-function gradient sums; SURVEY §2.3's "gradient
    all-reduce for the differentiable path"). Per-photon keys fold the
    global photon index, so integer tallies are bitwise equal to the
    single-device ``engine.simulate`` run with the same seed; float
    accumulators agree up to cross-shard summation order.

    `num_rays` must be a multiple of the mesh size. Scenes whose
    lights compile to device samplers emit on device (zero host
    transfer, lane regeneration per shard); others emit one host bundle
    and shard it (single-process only — host np.random emission cannot
    reproduce the global bundle across processes). `workers` is
    accepted for API compatibility and ignored; `record_every` must
    stay 0 (tallies only — use engine.simulate for histories).
    """
    from pvtrace_tpu.engine.api import _check_budget, _get_tables, compile_scene
    from pvtrace_tpu.engine.emit import emit_bundle

    if record_every:
        raise ValueError(
            "shard_simulate is tallies-only (record_every=0); use "
            "engine.simulate for event-log histories."
        )
    _check_budget(num_rays, index_offset)
    if compiled is None:
        compiled = compile_scene(scene)
    if seed is None:
        seed = int(np.random.randint(0, 2 ** 31 - 1))
    if dtype is None:
        dtype = (
            np.float64 if jax.config.read("jax_enable_x64") else np.float32
        )
    n_dev = mesh.devices.size
    if int(num_rays) % n_dev != 0:
        raise ValueError(
            f"num_rays ({num_rays}) must be a multiple of the mesh "
            f"size ({n_dev})."
        )
    cfg = tracer_module.make_config(
        compiled, n_rays=num_rays, dtype=dtype, maxsteps=maxsteps,
        maxpathlength=maxpathlength, max_events=max_events,
        record_every=0, emit_method=emit_method, score=score,
        pathwise=pathwise,
    )
    tables = _get_tables(compiled, dtype)
    base_key = jax.random.PRNGKey(seed)

    if compiled.lights_supported:
        per_shard = int(num_rays) // n_dev
        if lanes == "auto":
            lanes = min(per_shard, AUTO_LANES)
        traced = shard_trace_device_emit(
            compiled, cfg, mesh, lanes=lanes, axis_name=axis_name
        )
        tallies, steps = traced(tables, num_rays, base_key, index_offset)
    else:
        if distributed.is_multiprocess():
            raise ValueError(
                "Host-emitted scenes cannot shard_simulate across "
                "processes: each process's np.random bundle would "
                "differ. Use lights the compiler lowers to device "
                "samplers, or emit and shard the bundle explicitly "
                "with shard_trace."
            )
        pos, direction, wav, _src = emit_bundle(scene, num_rays)
        traced = shard_trace(compiled, cfg, mesh, axis_name=axis_name)
        tallies, steps = traced(
            tables, pos.astype(dtype), direction.astype(dtype),
            wav.astype(dtype), base_key, index_offset,
        )

    data = {
        "rec_distinct": np.asarray(tallies["distinct"]),
        "rec_crossings": np.asarray(tallies["cross"]),
        "rec_sums": np.asarray(tallies["sums"]),
        "rec_bins": np.asarray(tallies["bins"])[: cfg.total_bins],
        "fates": np.asarray(tallies["fates"]),
        "steps": int(np.asarray(steps)),
    }
    if score:
        data["fate_scores"] = np.asarray(tallies["fate_scores"])
        if "rec_scores" in tallies:
            data["rec_scores"] = np.asarray(tallies["rec_scores"])
    return data
