"""Python-facing API for the device tracing engine.

Parity: reference ``pvtrace/engine/api.py`` — ``simulate`` compiles the
scene, emits a bundle, traces it on the accelerator and wraps results in
``EngineResult`` / ``RecorderResult``; ``simulate_stream`` traces in
bundles whose union is identical to one big call. The execution
substrate is the JAX wavefront tracer instead of a Cython/OpenMP kernel.
"""
import collections
import os
import time

import numpy as np

from pvtrace_tpu.engine.compiler import EMIT_METHODS, compile_scene
from pvtrace_tpu.engine.emit import emit_bundle
from pvtrace_tpu.engine.recorder import Heatmap
from pvtrace_tpu.light.event import Event
from pvtrace_tpu.light.ray import Ray

# Properties with always-on moment accumulators, in tally order
MOMENT_PROPERTIES = ("wavelength", "angle", "duration", "pathlength")
# Wavefront width that lanes="auto" caps at: the fastest of 2^16..2^21
# on the benchmark slab at 10^8-photon calls on an H100 (docs/PERF.md).
AUTO_LANES = 1 << 20


def is_available() -> bool:
    """True when the device engine can run (jax imports)."""
    try:
        import jax  # noqa: F401
    except ImportError:
        return False
    return True


def _axis_edges(axis):
    return np.linspace(axis.start, axis.stop, axis.bins + 1)


class RecorderResult:
    """One recorder's accumulated statistics.

    Two counters: ``rays`` is distinct photons (first matching
    interaction only — a trapped photon bouncing off the same face many
    times is one ray) and ``crossings`` is every matching interaction.
    The moment pairs and histogram bins accumulate per distinct ray.
    """

    def __init__(self, spec, rays, crossings, moments, bins):
        self.spec = spec
        self.rays = int(rays)
        self.crossings = int(crossings)
        self._moments = np.asarray(moments, dtype=float)  # (4, 2)
        self._bins = bins  # list of arrays matching spec.histograms

    def _stats(self, prop):
        """(mean, population variance) of a moment property, or NaNs."""
        if self.rays == 0:
            return float("nan"), float("nan")
        total, squares = self._moments[MOMENT_PROPERTIES.index(prop)]
        mu = total / self.rays
        return mu, max(squares / self.rays - mu * mu, 0.0)

    def mean(self, prop):
        return self._stats(prop)[0]

    def std(self, prop):
        """Population standard deviation of `prop` over recorded rays."""
        return float(np.sqrt(self._stats(prop)[1]))

    def error(self, prop):
        """Standard error of the mean of `prop`."""
        if self.rays == 0:
            return float("nan")
        return self.std(prop) / np.sqrt(self.rays)

    def histogram(self, index=0):
        """(edges, counts) for 1D or (edges_a, edges_b, counts) for 2D."""
        spec = self.spec.histograms[index]
        counts = np.asarray(self._bins[index])
        if not isinstance(spec, Heatmap):
            return _axis_edges(spec), counts
        grid = counts.reshape(spec.a.bins, spec.b.bins)
        return _axis_edges(spec.a), _axis_edges(spec.b), grid

    def __repr__(self):
        return (
            f"RecorderResult({self.spec.name!r}, rays={self.rays}, "
            f"crossings={self.crossings})"
        )


class EngineResult:
    """Results of tracing a bundle of rays.

    Recorder tallies cover every traced ray (`recorders`); full event
    histories exist for every `record_every`-th ray (`histories()`).
    """

    def __init__(self, compiled, data, sources, max_events, record_every, elapsed):
        self.compiled = compiled
        self.data = data
        self.sources = sources
        self.max_events = max_events
        self.record_every = record_every
        self.elapsed = elapsed

    @property
    def num_rays(self):
        return len(self.sources)

    @property
    def num_recorded(self):
        return len(self.data["counts"])

    @property
    def recorded_indices(self):
        if self.record_every <= 0:
            return np.zeros(0, dtype=np.int64)
        return np.arange(0, self.num_rays, self.record_every, dtype=np.int64)

    @property
    def recorders(self):
        """Dict of recorder name -> RecorderResult, sliced out of the
        engine's flat accumulator arrays."""
        compiled = self.compiled
        flat_bins = self.data["rec_bins"]

        def slices(r, spec):
            start = compiled.rec_hist_start[r]
            for h in range(len(spec.histograms)):
                row = compiled.hist_specs[start + h]
                na, nb, offset = row[3], row[4], row[9]
                yield flat_bins[offset:offset + na * nb]

        return {
            spec.name: RecorderResult(
                spec,
                self.data["rec_distinct"][r],
                self.data["rec_crossings"][r],
                self.data["rec_sums"][r].reshape(4, 2),
                list(slices(r, spec)),
            )
            for r, spec in enumerate(compiled.recorder_specs)
        }

    def fate_counts(self):
        """Counter of terminal fates over EVERY traced ray (lossless,
        unlike `event_counts` which covers only recorded histories).
        Index 10 counts rays that left the scene without further hits."""
        fates = self.data["fates"]
        out = collections.Counter()
        for value in (Event.EXIT, Event.NONRADIATIVE, Event.REACT, Event.KILL):
            if fates[value.value]:
                out[value] = int(fates[value.value])
        if fates[10]:
            out["NO_HIT"] = int(fates[10])
        return out

    def event_counts(self):
        """Counter of logged events by Event member (recorded rays only)."""
        counts = self.data["counts"]
        if len(counts) == 0:
            return collections.Counter()
        kinds = self.data["kind"]
        mask = np.arange(self.max_events)[None, :] < counts[:, None]
        values, tallies = np.unique(kinds[mask], return_counts=True)
        return collections.Counter(
            {Event(int(v)): int(t) for v, t in zip(values, tallies)}
        )

    def _node_name(self, index):
        return self.compiled.node_names[index] if index >= 0 else None

    def _component_name(self, index):
        return self.compiled.component_names[index] if index >= 0 else None

    def _log_entry(self, j, k, launch_source):
        """One (Ray, Event, metadata) tuple from event-log slot (j, k)."""
        d = self.data
        component_id = int(d["source"][j, k])
        ray = Ray(
            position=tuple(np.asarray(d["position"][j, k]).tolist()),
            direction=tuple(np.asarray(d["direction"][j, k]).tolist()),
            wavelength=float(d["wavelength"][j, k]),
            travelled=float(d["travelled"][j, k]),
            duration=float(d["duration"][j, k]),
            source=(
                launch_source if component_id < 0
                else self._component_name(component_id)
            ),
        )
        event = Event(int(d["kind"][j, k]))
        metadata = {
            key: lookup(int(d[key][j, k]))
            for key, lookup in (
                ("hit", self._node_name),
                ("container", self._node_name),
                ("adjacent", self._node_name),
                ("component", self._component_name),
            )
        }
        if event in (Event.REFLECT, Event.TRANSMIT):
            metadata["normal"] = tuple(np.asarray(d["normal"][j, k]).tolist())
        return ray, event, metadata

    def histories(self):
        """Yields one history per recorded ray: [(Ray, Event, metadata)]."""
        counts = self.data["counts"]
        indices = self.recorded_indices
        for j in range(self.num_recorded):
            launch_source = self.sources[int(indices[j])]
            yield [
                self._log_entry(j, k, launch_source)
                for k in range(int(counts[j]))
            ]


# Cache of jitted tracers keyed by (id(compiled), static config)
_TRACER_CACHE = {}
# Cache of device tables keyed by (id(compiled), dtype)
_TABLE_CACHE = {}


def _get_tables(compiled, dtype):
    key = (compiled.content_digest, np.dtype(dtype).str)
    tables = _TABLE_CACHE.get(key)
    if tables is None:
        tables = compiled.device_tables(dtype=dtype)
        _TABLE_CACHE[key] = tables
    return tables


class _RoundRobinSources:
    """Lazy `sources` sequence: light names cycled over the bundle
    (building a python list of 10^6+ strings is host-time we don't
    spend). `offset` is the bundle's global photon-index offset so
    streamed bundles label sources exactly like one big call."""

    def __init__(self, names, n, offset=0):
        self._names = list(names)
        self._n = n
        self._offset = offset

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        return self._names[(self._offset + i) % len(self._names)]


_CACHE_ENABLED = False
# The checkout that holds this package; the default cache lives in it.
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def _cache_dir(environ):
    """Directory of the persistent XLA compilation cache.

    ``JAX_COMPILATION_CACHE_DIR`` when set; otherwise ``.xla_cache`` in
    the checkout (git-ignored). The path is fixed because it is part of
    what a later process must find again.
    """
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".xla_cache"
    )


def _enable_persistent_cache():
    """Persistent XLA compilation cache: per-scene programs take seconds
    to minutes to compile. Opt out with PVTRACE_TPU_NO_CACHE=1."""
    global _CACHE_ENABLED
    if _CACHE_ENABLED or os.environ.get("PVTRACE_TPU_NO_CACHE"):
        return
    _CACHE_ENABLED = True
    import jax

    # JAX itself reads JAX_COMPILATION_CACHE_DIR; a directory the user
    # configured is kept.
    if not jax.config.jax_compilation_cache_dir:
        path = _cache_dir(os.environ)
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


def _get_tracer(compiled, cfg, lanes=None):
    import jax

    from pvtrace_tpu.engine import tracer as tracer_module

    _enable_persistent_cache()

    key = (compiled.content_digest, cfg, bool(compiled.lights_supported), lanes)
    fn = _TRACER_CACHE.get(key)
    if fn is None:
        import jax.numpy as jnp

        def pack(tallies, log, counts, steps):
            # Pack every small output into ONE flat int32 array (floats
            # bitcast in) so the host makes one device->host fetch, plus
            # the event log only in validation runs.
            ints = jnp.concatenate(
                [
                    tallies["distinct"],
                    tallies["cross"],
                    tallies["bins"],
                    tallies["fates"],
                    counts,
                    jnp.reshape(steps, (1,)),
                ]
            )
            floats = jnp.ravel(tallies["sums"])
            if cfg.score:
                floats = jnp.concatenate(
                    [floats, jnp.ravel(tallies["fate_scores"])]
                )
                if "rec_scores" in tallies:
                    floats = jnp.concatenate(
                        [floats, jnp.ravel(tallies["rec_scores"])]
                    )
            if floats.dtype == jnp.float32:
                # Single-fetch path: bitcast the float block into the
                # int array; simulate() views it back.
                packed = jnp.concatenate(
                    [ints, jax.lax.bitcast_convert_type(floats, jnp.int32)]
                )
                return packed, None, (log if cfg.n_slots > 0 else None)
            return ints, floats, (log if cfg.n_slots > 0 else None)

        if compiled.lights_supported:

            def traced(tables, n_rays, offset, seed):
                k = jax.random.PRNGKey(seed[0])
                return pack(
                    *tracer_module.trace_bundle_device_emit(
                        compiled, cfg, tables, k, n_rays, lanes=lanes,
                        index_offset=offset,
                    )
                )

            if lanes is not None and cfg.n_slots == 0:
                # Regeneration with no event log: the photon budget is
                # only compared against, so trace it — one compile
                # serves any num_rays > lanes.
                fn = jax.jit(traced)
            else:
                fn = jax.jit(traced, static_argnums=(1,))
        else:

            def traced(tables, p, d, w, offset, seed):
                k = jax.random.PRNGKey(seed[0])
                return pack(
                    *tracer_module.trace_bundle(
                        compiled, cfg, tables, p, d, w, k,
                        index_offset=offset,
                    )
                )

            fn = jax.jit(traced)
        _TRACER_CACHE[key] = fn
    return fn


def _check_budget(num_rays, index_offset=0):
    """Reject budgets that would wrap the tracer's integer ranges.

    Photon ids are uint32 (`index_offset + [0, num_rays)` feeds the
    per-photon threefry streams) — a wrap would silently reuse random
    streams; fate/recorder counters are int32. Both bounds are per
    call: stream bigger runs in bundles (`simulate_stream`) and sum the
    integer tallies in int64 on the host.
    """
    if num_rays <= 0:
        raise ValueError(f"num_rays must be positive, got {num_rays}")
    if num_rays > 2 ** 31 - 1:
        raise ValueError(
            f"num_rays ({num_rays}) exceeds the int32 tally counters; "
            "trace in bundles with simulate_stream / index_offset and "
            "sum the integer tallies in int64 on the host."
        )
    if index_offset < 0 or index_offset + num_rays > 2 ** 32:
        raise ValueError(
            f"photon ids index_offset + [0, num_rays) = "
            f"[{index_offset}, {index_offset + num_rays}) must fit in "
            "uint32 — a wrap would silently reuse per-photon random "
            "streams."
        )


def simulate(
    scene,
    num_rays,
    seed=None,
    workers=None,
    maxsteps=1000,
    maxpathlength=None,
    max_events=128,
    emit_method="kT",
    record_every=1,
    dtype=None,
    compiled=None,
    lanes="auto",
    score=False,
    pathwise=(),
    index_offset=0,
):
    """Trace `num_rays` through `scene` with the device engine.

    Initial rays are emitted by the scene's light sources on the host
    (all light delegates supported); the tracing loop runs on the
    accelerator. Raises `UnsupportedSceneError` when the scene cannot be
    compiled — fall back to the Python tracer.

    `workers` is accepted for API compatibility and ignored: parallelism
    comes from the device batch (and the mesh when sharded).

    `lanes` sets the wavefront width for device-emitted bundles. When
    smaller than `num_rays`, dead lanes are refilled with new photons
    (regeneration) so the loop cost follows the mean photon lifetime,
    not the max. "auto" picks `min(num_rays, AUTO_LANES)`; None disables
    regeneration.

    COST NOTE: `record_every > 0` (event-log histories) switches the
    tracer off its tallies-only fast path — every step additionally
    writes packed event records and the run allocates O(n_slots *
    max_events) device memory — expect lower throughput and use it
    for validation/debugging, not production tallies. `record_every=0`
    keeps recorders and fates exact with none of that cost.

    With `score=True` the tracer also accumulates score-function
    (likelihood-ratio) gradient sums: `result.data["fate_scores"][f, c]`
    such that d(fraction of fate f)/d log(scale of component c) =
    fate_scores[f, c] / num_rays. `pathwise` appends hybrid
    tangent-propagation channels for refractive-index and geometry
    parameters (tracer-level specs — use
    `diff.transport.resolve_pathwise_params` / `fate_gradients` for the
    name-based API). See `pvtrace_tpu.diff.transport` and
    docs/GRADIENTS.md.
    """
    import jax
    import jax.numpy as jnp

    from pvtrace_tpu.engine import tracer as tracer_module

    if emit_method not in EMIT_METHODS:
        raise ValueError(f"emit_method must be one of {sorted(EMIT_METHODS)}")
    _check_budget(num_rays, index_offset)
    if compiled is None:
        compiled = compile_scene(scene)
    if seed is None:
        seed = int(np.random.randint(0, 2 ** 31 - 1))
    if dtype is None:
        dtype = (
            np.float64
            if jax.config.read("jax_enable_x64")
            else np.float32
        )

    cfg = tracer_module.make_config(
        compiled,
        n_rays=num_rays,
        dtype=dtype,
        maxsteps=maxsteps,
        maxpathlength=maxpathlength,
        max_events=max_events,
        record_every=record_every,
        emit_method=emit_method,
        score=score,
        pathwise=pathwise,
    )
    if lanes == "auto":
        lanes = min(num_rays, AUTO_LANES)
    if lanes is not None and lanes >= num_rays:
        lanes = None
    tables = _get_tables(compiled, dtype)
    fn = _get_tracer(
        compiled, cfg, lanes=lanes if compiled.lights_supported else None
    )
    # Host-side numpy scalars/arrays: jit ships them with the dispatch.
    seed_arr = np.asarray([seed], dtype=np.uint32)
    offset_arr = np.uint32(index_offset)

    if compiled.lights_supported:
        # Device-side emission: no host sampling, no bundle transfer.
        sources = _RoundRobinSources(
            compiled.light_names, num_rays, offset=index_offset
        )
        tic = time.perf_counter()
        ints_dev, floats_dev, log = fn(tables, num_rays, offset_arr, seed_arr)
    else:
        positions, directions, wavelengths, sources = emit_bundle(
            scene, num_rays
        )
        tic = time.perf_counter()
        ints_dev, floats_dev, log = fn(
            tables,
            positions.astype(dtype),
            directions.astype(dtype),
            wavelengths.astype(dtype),
            offset_arr,
            seed_arr,
        )

    R = max(compiled.n_recorders, 1)
    S = max(cfg.n_slots, 1)
    n_int = R + R + (cfg.total_bins + 1) + 11 + S + 1
    # The fetch below waits for execution — one round trip total.
    if floats_dev is None:
        # Single-fetch path: the float block rides bitcast inside the
        # int array (see pack() in _get_tracer).
        packed = np.asarray(ints_dev)
        ints = packed[:n_int]
        floats = packed[n_int:].view(np.float32)
    else:
        ints = np.asarray(ints_dev)
        floats = np.asarray(floats_dev)
    elapsed = time.perf_counter() - tic
    parts = np.split(
        ints,
        np.cumsum([R, R, cfg.total_bins + 1, 11, S]),
    )
    distinct, crossings, bins, fates, counts, steps = parts
    data = {
        "rec_distinct": distinct,
        "rec_crossings": crossings,
        "rec_sums": floats[: R * 8].reshape(R, 8),
        "rec_bins": bins[:-1],  # drop overflow slot
        "fates": fates,
        "counts": counts[: cfg.n_slots],
        "steps": int(steps[0]),
    }
    if score:
        # Channel layout: [0, n_comps) component log-scale scores,
        # [n_comps, n_comps + n_nodes) refractive-index scores.
        CH = cfg.n_comps + cfg.n_nodes + len(cfg.pathwise)
        data["fate_scores"] = floats[R * 8: R * 8 + 11 * CH].reshape(11, CH)
        if cfg.n_recorders > 0:
            data["rec_scores"] = floats[R * 8 + 11 * CH:].reshape(
                cfg.n_recorders, CH
            )
    # Unpack the two packed log arrays into the per-field view the
    # result API exposes (see tracer._LOG_INTS / _LOG_VECS layout).
    # Production runs (record_every=0) never fetch the device log.
    rows = cfg.n_slots if cfg.n_slots > 0 else 0
    if log is None or rows == 0:
        log_ints = np.full((0, max_events, 6), -1, dtype=np.int32)
        log_floats = np.zeros((0, max_events, 12), dtype=dtype)
    else:
        log_ints = np.asarray(log["ints"])[:rows]
        log_floats = np.asarray(log["floats"])[:rows]
    for i, name in enumerate(
        ("kind", "hit", "container", "adjacent", "component", "source")
    ):
        data[name] = log_ints[..., i]
    for i, name in enumerate(("position", "direction", "normal")):
        data[name] = log_floats[..., 3 * i: 3 * i + 3]
    for i, name in enumerate(("wavelength", "travelled", "duration")):
        data[name] = log_floats[..., 9 + i]

    return EngineResult(compiled, data, sources, max_events, record_every, elapsed)


def simulate_stream(scene, num_rays, bundle=50000, seed=None, **kwargs):
    """Trace in bundles, yielding (EngineResult, rays_traced_so_far).

    Exact streamed union (parity with the reference's consecutive
    per-ray seed offsets, reference engine/api.py:249-264): every bundle
    shares ONE base seed and passes its global start index as
    ``index_offset``, and each photon's entire random stream is a pure
    function of (seed, global photon id). The union of the streamed
    results therefore equals a single `simulate(num_rays)` call exactly:
    integer tallies (counts, crossings, histogram bins, fates) are
    bitwise identical, float moment sums agree up to summation order,
    and recorded histories cover the same global every-k-th photons.
    Accumulate recorder tallies across bundles by summing the `rec_*`
    arrays.
    """
    if seed is None:
        seed = int(np.random.randint(0, 2 ** 31 - 1))
    if num_rays > 2 ** 32:
        # Fail up front, not at the bundle whose photon ids would wrap
        # uint32 mid-stream (_check_budget rejects it per bundle too).
        raise ValueError(
            f"num_rays ({num_rays}) exceeds the 2^32 photon-id space "
            "of one stream; run several streams with distinct seeds "
            "and sum their tallies."
        )
    compiled = kwargs.pop("compiled", None)
    if compiled is None:
        compiled = compile_scene(scene)

    # One-bundle prefetch: per-call overhead (dispatch and the result
    # fetch) dominates small streamed bundles, so bundle k+1 runs in a
    # worker thread while the caller consumes bundle k. Results are identical — each bundle is
    # an independent (seed, index_offset) call.
    from concurrent.futures import ThreadPoolExecutor

    def run(start, n):
        return simulate(
            scene, n, seed=int(seed), index_offset=start,
            compiled=compiled, **kwargs
        )

    if num_rays <= 0:
        return
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        traced = 0
        n = min(bundle, num_rays - traced)
        pending = pool.submit(run, traced, n)
        while traced < num_rays:
            result = pending.result()
            traced += n
            if traced < num_rays:
                n = min(bundle, num_rays - traced)
                pending = pool.submit(run, traced, n)
            yield result, traced
    finally:
        pool.shutdown(wait=True)
