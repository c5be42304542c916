"""Device engine validation against the Python oracle tracer.

Mirrors the reference test strategy (tests/test_engine.py): the oracle
is the reference implementation; the engine must be a sampler of the
same distributions. We pin distributions — Welch tests on event-count
means, two-proportion z-tests on fate fractions, exact recorder
cross-checks against the engine's own event log and the pure-Python
tally oracle — never RNG streams.
"""
import numpy as np
import pytest

from pvtrace_tpu import (
    Absorber,
    Box,
    Event,
    Light,
    Luminophore,
    Material,
    Node,
    Scene,
    Sphere,
    engine,
    photon_tracer,
)
from pvtrace_tpu.engine import (
    Heatmap,
    Histogram,
    Recorder,
    UnsupportedSceneError,
    compile_scene,
    tally_histories,
)
from pvtrace_tpu.geometry.mesh import Mesh


def make_fresnel_scene():
    """Glass box in air — surface physics only."""
    world = Node(
        name="world",
        geometry=Sphere(radius=10.0, material=Material(refractive_index=1.0)),
    )
    box = Node(
        name="box",
        geometry=Box((1.0, 1.0, 1.0), material=Material(refractive_index=1.5)),
        parent=world,
    )
    light = Node(name="light", light=Light(), parent=world)
    light.translate((0.0, 0.0, -5.0))
    return Scene(world), box


def make_lsc_scene(qy=0.9):
    """Small LSC slab: re-absorption, emission, background losses."""
    world = Node(
        name="world",
        geometry=Sphere(radius=10.0, material=Material(refractive_index=1.0)),
    )
    x = np.linspace(400.0, 800.0, 200)
    absorption = np.exp(-(((550.0 - x) / 40.0) ** 2)) * 5.0
    emission = np.exp(-(((600.0 - x) / 40.0) ** 2))
    lum = Luminophore(
        coefficient=np.column_stack((x, absorption)),
        emission=np.column_stack((x, emission)),
        quantum_yield=qy,
        name="dye",
    )
    background = Absorber(0.1, name="background")
    lsc = Node(
        name="lsc",
        geometry=Box(
            (5.0, 5.0, 1.0),
            material=Material(
                refractive_index=1.5, components=[lum, background]
            ),
        ),
        parent=world,
    )
    from pvtrace_tpu.light.light import ConstantWavelengthMask

    light = Node(
        name="light", light=Light(wavelength=ConstantWavelengthMask(555.0)),
        parent=world,
    )
    light.translate((0.0, 0.0, -3.0))
    return Scene(world), lsc


def oracle_fates(scene, n, seed=1, emit_method="kT"):
    np.random.seed(seed)
    fates = {}
    event_counts = []
    for ray in scene.emit(n):
        history = photon_tracer.follow(scene, ray, emit_method=emit_method)
        events = [e for _, e in history]
        event_counts.append(len(events))
        fates[events[-1].name] = fates.get(events[-1].name, 0) + 1
    return fates, np.asarray(event_counts, dtype=float)


def engine_fates(scene, n, seed=1, emit_method="kT", **kwargs):
    np.random.seed(seed + 7)
    result = engine.simulate(
        scene, n, seed=seed, emit_method=emit_method, record_every=1, **kwargs
    )
    fates = {}
    event_counts = []
    for history in result.histories():
        events = [e for _, e, _ in history]
        event_counts.append(len(events))
        fates[events[-1].name] = fates.get(events[-1].name, 0) + 1
    return fates, np.asarray(event_counts, dtype=float), result


def assert_means_close(a, b, sigmas=5.0):
    """Welch test on sample means (reference test_engine.py:126-137)."""
    se = np.sqrt(np.var(a, ddof=1) / len(a) + np.var(b, ddof=1) / len(b))
    assert abs(np.mean(a) - np.mean(b)) < sigmas * max(se, 1e-12), (
        np.mean(a),
        np.mean(b),
        se,
    )


def assert_proportions_close(k1, n1, k2, n2, sigmas=5.0):
    p = (k1 + k2) / (n1 + n2)
    se = np.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))
    assert abs(k1 / n1 - k2 / n2) < sigmas * max(se, 1e-12), (k1 / n1, k2 / n2)


N_RAYS = 600


class TestEngineVsOracle:
    def test_fresnel_scene_statistics(self):
        scene, _ = make_fresnel_scene()
        o_fates, o_events = oracle_fates(scene, N_RAYS)
        e_fates, e_events, _ = engine_fates(scene, N_RAYS)
        assert set(e_fates) == set(o_fates) == {"EXIT"}
        assert_means_close(o_events, e_events)

    def test_lsc_scene_statistics(self):
        scene, _ = make_lsc_scene()
        o_fates, o_events = oracle_fates(scene, N_RAYS)
        e_fates, e_events, _ = engine_fates(scene, N_RAYS)
        assert_means_close(o_events, e_events)
        for fate in set(o_fates) | set(e_fates):
            assert_proportions_close(
                o_fates.get(fate, 0), N_RAYS, e_fates.get(fate, 0), N_RAYS
            )

    def test_lsc_exit_wavelengths_redshift(self):
        scene, _ = make_lsc_scene()
        _, _, result = engine_fates(scene, N_RAYS, emit_method="redshift")
        exit_wavelengths = []
        for history in result.histories():
            prev = None
            for ray, event, _ in history:
                if event == Event.ABSORB:
                    prev = ray.wavelength
                if event == Event.EMIT and prev is not None:
                    assert ray.wavelength >= prev - 1.0  # grid resolution slack
        # Spectrum as a whole must redshift
        final = [h[-1][0].wavelength for h in result.histories()
                 if h[-1][1] == Event.EXIT]
        emitted = [w for w in final if w > 560.0]
        assert len(emitted) > 0

    def test_determinism_same_seed(self):
        scene, _ = make_fresnel_scene()
        _, e1, r1 = engine_fates(scene, 200, seed=5)
        _, e2, r2 = engine_fates(scene, 200, seed=5)
        assert np.array_equal(e1, e2)
        assert np.array_equal(r1.data["kind"], r2.data["kind"])
        assert np.array_equal(r1.data["position"], r2.data["position"])

    def test_different_seeds_differ(self):
        scene, _ = make_fresnel_scene()
        _, e1, r1 = engine_fates(scene, 200, seed=5)
        _, e2, r2 = engine_fates(scene, 200, seed=6)
        assert not np.array_equal(r1.data["position"], r2.data["position"])

    def test_mesh_scenes_compile(self):
        # Beyond-reference capability: the reference engine rejects
        # meshes (engine/compiler.py:53); pvtrace_tpu compiles them
        # (see tests/test_mesh_engine.py for tracing validation).
        from pvtrace_tpu.engine.compiler import GEOM_MESH

        scene, _ = make_fresnel_scene()
        v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1.0]])
        fcs = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]])
        Node(
            name="mesh",
            geometry=Mesh((v, fcs), material=Material(refractive_index=1.3)),
            parent=scene.root,
        )
        compiled = compile_scene(scene)
        mesh_index = list(compiled.node_names).index("mesh")
        assert compiled.geom_type[mesh_index] == GEOM_MESH
        assert mesh_index in compiled.mesh_data

    def test_absorption_depth_distribution(self):
        """Engine samples Beer-Lambert depths with the right mean."""
        scene, _ = make_fresnel_scene()
        box = scene.root.children[0]
        alpha = 5.0
        box.geometry.material.components.append(Absorber(alpha, name="a"))
        _, _, result = engine_fates(scene, 800)
        depths = []
        for history in result.histories():
            for ray, event, _ in history:
                if event == Event.ABSORB:
                    depths.append(ray.position[2] + 0.5)
        depths = np.asarray(depths)
        expected = 1 / alpha - np.exp(-alpha) / (1 - np.exp(-alpha))
        assert np.isclose(
            depths.mean(), expected,
            atol=4 * depths.std() / np.sqrt(len(depths)),
        )


class TestRecorders:
    def make_recorded_scene(self):
        scene, lsc = make_lsc_scene()
        lsc.recorders = [
            Recorder(
                "top-escape",
                event="escaping",
                facet=(0.0, 0.0, 1.0),
                histograms=[
                    Histogram("wavelength", 400, 800, 40),
                    Heatmap("x", "y", (-2.5, 2.5, 10), (-2.5, 2.5, 10)),
                ],
            ),
            Recorder("entering", event="entering"),
            Recorder("lost", event="lost",
                     histograms=[Histogram("wavelength", 400, 800, 40)]),
            Recorder("reflected", event="reflected"),
        ]
        scene.root.recorders = [Recorder("exit", event="exit")]
        return scene, lsc

    def test_recorders_match_event_log(self):
        """Device tallies must match tallies recomputed from the device
        event log exactly (reference test_engine.py:204-262)."""
        scene, _ = self.make_recorded_scene()
        np.random.seed(3)
        result = engine.simulate(scene, 400, seed=9, record_every=1)
        oracle = tally_histories(scene, result.histories())
        for name, rec in result.recorders.items():
            expect = oracle[name]
            assert rec.rays == expect.rays, name
            assert rec.crossings == expect.crossings, name
            assert np.allclose(rec._moments, expect._moments, rtol=1e-9), name
            for h in range(len(rec.spec.histograms)):
                got = rec.histogram(h)[-1]
                want = expect.histogram(h)[-1]
                assert np.array_equal(got, want), (name, h)

    def test_recorders_invariant_to_record_every(self):
        """Tallies cover every ray regardless of history sampling."""
        scene, _ = self.make_recorded_scene()
        np.random.seed(3)
        r1 = engine.simulate(scene, 300, seed=11, record_every=1)
        np.random.seed(3)
        r2 = engine.simulate(scene, 300, seed=11, record_every=0)
        for name in r1.recorders:
            a, b = r1.recorders[name], r2.recorders[name]
            assert a.rays == b.rays
            assert a.crossings == b.crossings

    def test_recorder_statistics_vs_python_tracer(self):
        """Two-proportion z-test: engine recorder counts vs oracle-traced
        tallies (reference test_engine.py:321-350)."""
        scene, _ = self.make_recorded_scene()
        n = 400
        np.random.seed(4)
        histories = []
        for ray in scene.emit(n):
            histories.append(
                list(photon_tracer.step_forward(scene, ray))
            )
        oracle = tally_histories(scene, histories)
        np.random.seed(5)
        result = engine.simulate(scene, n, seed=21, record_every=0)
        for name, rec in result.recorders.items():
            assert_proportions_close(
                oracle[name].rays, n, rec.rays, n, sigmas=5.0
            )

    def test_null_surface_counts(self):
        """Null-surface box: every entering ray counted once, none
        reflected."""
        from pvtrace_tpu.material.surface import NullSurfaceDelegate, Surface

        scene, box = make_fresnel_scene()
        box.geometry.material.surface = Surface(delegate=NullSurfaceDelegate())
        box.recorders = [
            Recorder("in", event="entering"),
            Recorder("back", event="reflected"),
        ]
        result = engine.simulate(scene, 200, seed=2, record_every=0)
        assert result.recorders["in"].rays == 200
        assert result.recorders["back"].rays == 0


class TestStream:
    def test_stream_accumulates(self):
        scene, lsc = make_lsc_scene()
        lsc.recorders = [Recorder("in", event="entering")]
        total = 0
        rays = 0
        for result, traced in engine.simulate_stream(
            scene, 500, bundle=200, seed=3, record_every=0
        ):
            total += result.recorders["in"].rays
            rays = traced
        assert rays == 500
        assert 350 < total <= 500

    @pytest.mark.slow
    def test_stream_union_is_exact(self):
        """The union of streamed bundles equals one big call EXACTLY
        (integer tallies bitwise) — the reference guarantee
        (reference engine/api.py:249-264), achieved with one base seed
        + per-bundle index offsets so each photon's stream is a pure
        function of (seed, global photon id)."""
        scene, lsc = make_lsc_scene()
        lsc.recorders = [
            Recorder(
                "in",
                event="entering",
                histograms=[Histogram("wavelength", 400, 800, 20)],
            ),
            Recorder("lost", event="lost"),
        ]
        single = engine.simulate(
            scene, 900, seed=17, record_every=0, lanes=None
        )
        acc = None
        for result, _traced in engine.simulate_stream(
            scene, 900, bundle=250, seed=17, record_every=0, lanes=None
        ):
            part = {
                k: np.asarray(result.data[k])
                for k in ("rec_distinct", "rec_crossings", "rec_bins",
                          "fates")
            }
            if acc is None:
                acc = part
            else:
                acc = {k: acc[k] + part[k] for k in acc}
        for k in acc:
            np.testing.assert_array_equal(
                acc[k], np.asarray(single.data[k]), err_msg=k
            )

    def test_stream_union_is_exact_with_regeneration(self):
        """Same exactness when bundles run in lane-regeneration mode."""
        scene, _lsc = make_lsc_scene()
        single = engine.simulate(
            scene, 1000, seed=23, record_every=0, lanes=128
        )
        fates = np.zeros(11, dtype=np.int64)
        for result, _traced in engine.simulate_stream(
            scene, 1000, bundle=400, seed=23, record_every=0, lanes=128
        ):
            fates += np.asarray(result.data["fates"])
        np.testing.assert_array_equal(
            fates, np.asarray(single.data["fates"])
        )


class TestMaxPathlength:
    def test_maxpathlength_matches_oracle(self):
        """Pathlength cap kills in the device tracer match the oracle's
        semantics (reference photon_tracer.py:163-173) statistically.
        Uses a qy=1 LSC so TIR-trapped re-emission paths outlive the
        cap (an open scene exits before any cap can bite)."""
        scene, _lsc = make_lsc_scene(qy=1.0)
        cap = 6.0
        n_engine = 4000
        result = engine.simulate(
            scene, n_engine, seed=5, record_every=0, maxpathlength=cap
        )
        fates = result.fate_counts()
        killed_engine = fates.get(Event.KILL, 0)
        assert killed_engine > 0

        np.random.seed(4)
        n_oracle = 300
        killed_oracle = 0
        for ray in scene.emit(n_oracle):
            history = photon_tracer.follow(scene, ray, maxpathlength=cap)
            if history[-1][1] == Event.KILL:
                killed_oracle += 1
        p1 = killed_engine / n_engine
        p2 = killed_oracle / n_oracle
        p = (killed_engine + killed_oracle) / (n_engine + n_oracle)
        z = (p1 - p2) / np.sqrt(
            p * (1 - p) * (1 / n_engine + 1 / n_oracle)
        )
        assert abs(z) < 5, (p1, p2, z)

    def test_no_cap_means_no_kills(self):
        scene, _box = make_fresnel_scene()
        result = engine.simulate(scene, 500, seed=5, record_every=0)
        assert Event.KILL not in result.fate_counts()


def test_many_recorders_exact_vs_log():
    """48 recorders (mixed facet filters, histograms and heatmaps) on
    one node: the vectorized [B, R] tally must match tallies recomputed
    from the event log exactly — guards the matmul histogram path and the
    recorder-axis vectorization at a scale past every other test."""
    scene, lsc = make_lsc_scene()
    faces = [
        (0, 0, 1), (0, 0, -1), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
    ]
    events = ["escaping", "entering", "reflected"]
    recs = []
    for i in range(48):
        event = events[i % 3]
        hists = []
        if i % 4 == 0:
            hists = [Histogram("wavelength", 400, 800, 25)]
        elif i % 4 == 1:
            hists = [Heatmap("x", "y", (-2.5, 2.5, 6), (-2.5, 2.5, 6))]
        recs.append(
            Recorder(
                f"m{i:02d}", event=event, facet=faces[i % 6],
                histograms=hists,
            )
        )
    lsc.recorders = recs
    np.random.seed(6)
    result = engine.simulate(scene, 250, seed=17, record_every=1,
                             maxsteps=60)
    oracle = tally_histories(scene, result.histories())
    for name, rec in result.recorders.items():
        expect = oracle[name]
        assert rec.rays == expect.rays, name
        assert rec.crossings == expect.crossings, name
        for h in range(len(rec.spec.histograms)):
            got = rec.histogram(h)[-1]
            want = expect.histogram(h)[-1]
            assert np.array_equal(got, want), (name, h)


def test_budget_guard_rejects_integer_wrap():
    """Photon ids are uint32 and tally counters int32: budgets or
    offsets that would wrap must fail loudly (a silent uint32 wrap
    would reuse per-photon random streams; engine/api.py::_check_budget)."""
    scene, _box = make_fresnel_scene()
    with pytest.raises(ValueError, match="int32"):
        engine.simulate(scene, 2 ** 31, seed=1, record_every=0)
    with pytest.raises(ValueError, match="uint32"):
        engine.simulate(
            scene, 1_000, seed=1, record_every=0,
            index_offset=2 ** 32 - 500,
        )
    with pytest.raises(ValueError, match="positive"):
        engine.simulate(scene, 0, seed=1, record_every=0)


def test_stream_and_checkpoint_reject_id_space_overflow():
    """Streams and checkpointed runs own the contiguous photon-id range
    [0, num_rays): budgets past 2^32 must fail up front, not at the
    bundle whose uint32 ids would wrap mid-run."""
    scene, _box = make_fresnel_scene()
    with pytest.raises(ValueError, match="2\\^32"):
        next(engine.simulate_stream(scene, 2 ** 32 + 8, seed=1))
    with pytest.raises(ValueError, match="2\\^32"):
        engine.simulate_checkpointed(
            scene, 2 ** 32 + 8, checkpoint=None, seed=1
        )


@pytest.mark.parametrize(
    "environ, expect",
    [
        ({"JAX_COMPILATION_CACHE_DIR": "/cache/here"}, "/cache/here"),
        ({}, None),
        ({"PVTRACE_TPU_CACHE_DIR": "/not/used"}, None),
    ],
    ids=["env-set", "env-unset", "old-variable-ignored"],
)
def test_compile_cache_dir(environ, expect):
    """JAX_COMPILATION_CACHE_DIR wins; otherwise one fixed, git-ignored
    directory in the checkout. No other variable moves it."""
    import os

    from pvtrace_tpu.engine.api import _CHECKOUT, _cache_dir

    got = _cache_dir(environ)
    if expect is not None:
        assert got == expect
        return
    assert got == os.path.join(_CHECKOUT, ".xla_cache")
    assert os.path.isdir(os.path.join(_CHECKOUT, "pvtrace_tpu"))
    with open(os.path.join(_CHECKOUT, ".gitignore")) as fh:
        assert ".xla_cache/" in fh.read().split()
