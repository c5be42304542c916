"""Multi-chip sharding tests (virtual 8-device CPU mesh).

The guarantee under test: per-photon key streams fold the global photon
index and the photon's own step counter, so recorder tallies are
BITWISE identical whether a bundle is traced on one device, sharded
over a mesh, or run through regeneration at any lane width — the
analogue of the reference's scheduling-independent per-ray RNG streams
(``_kernel.pyx:71-77``, ``tests/test_engine.py:169-176``).
"""
import jax
import numpy as np
import pytest

from pvtrace_tpu import (
    Absorber,
    Box,
    Light,
    Luminophore,
    Material,
    Node,
    Scene,
    Sphere,
    engine,
)
from pvtrace_tpu.data import lumogen_f_red_305
from pvtrace_tpu.engine import tracer as tracer_module
from pvtrace_tpu.engine.api import _get_tables
from pvtrace_tpu.engine.emit import emit_bundle
from pvtrace_tpu.engine.recorder import Histogram, Recorder
from pvtrace_tpu.light.light import ConstantWavelengthMask
from pvtrace_tpu.parallel.shard import (
    make_photon_mesh,
    shard_trace,
    shard_trace_device_emit,
)


def lsc_scene():
    x = np.arange(400, 801, dtype=float)
    world = Node(
        name="world",
        geometry=Sphere(radius=12.0, material=Material(refractive_index=1.0)),
    )
    lsc = Node(
        name="lsc",
        geometry=Box(
            (5.0, 5.0, 1.0),
            material=Material(
                refractive_index=1.5,
                components=[
                    Luminophore(
                        coefficient=np.column_stack(
                            (x, lumogen_f_red_305.absorption(x) * 8.0)
                        ),
                        emission=np.column_stack(
                            (x, lumogen_f_red_305.emission(x))
                        ),
                        quantum_yield=0.9,
                    ),
                    Absorber(0.2),
                ],
            ),
        ),
        parent=world,
    )
    lsc.recorders = [
        Recorder(
            "escape",
            event="escaping",
            histograms=[Histogram("wavelength", 400, 800, 40)],
        )
    ]
    light = Node(
        name="light",
        light=Light(wavelength=ConstantWavelengthMask(555.0)),
        parent=world,
    )
    light.translate((0.0, 0.0, 3.0))
    light.rotate(np.radians(180), (1, 0, 0))
    return Scene(world)


@pytest.fixture(scope="module")
def setup():
    scene = lsc_scene()
    compiled = engine.compile_scene(scene)
    cfg = tracer_module.make_config(
        compiled, n_rays=8000, dtype=np.float64, record_every=0
    )
    tables = _get_tables(compiled, np.float64)
    return scene, compiled, cfg, tables


def assert_tallies_equal(a, b, cfg):
    # bins[total_bins] is the scatter-add overflow slot; it counts every
    # non-matching interaction per loop step, so it varies with loop
    # length and is dropped by the results API — exclude it here too.
    T = cfg.total_bins
    for name in ("distinct", "cross", "fates"):
        assert (np.asarray(a[name]) == np.asarray(b[name])).all(), name
    assert (np.asarray(a["bins"])[:T] == np.asarray(b["bins"])[:T]).all()


def test_sharded_host_bundle_matches_single_device(setup):
    scene, compiled, cfg, tables = setup
    mesh = make_photon_mesh()
    assert mesh.devices.size == 8
    np.random.seed(0)
    pos, direction, wav, _src = emit_bundle(scene, 8000)
    key = jax.random.PRNGKey(3)
    f64 = np.float64

    sharded = shard_trace(compiled, cfg, mesh)
    tallies, steps = sharded(
        tables, pos.astype(f64), direction.astype(f64), wav.astype(f64), key
    )

    single, _log, _counts, _steps = jax.jit(
        lambda: tracer_module.trace_bundle(
            compiled, cfg, tables,
            pos.astype(f64), direction.astype(f64), wav.astype(f64), key,
        )
    )()
    assert_tallies_equal(tallies, single, cfg)
    np.testing.assert_allclose(
        np.asarray(tallies["sums"]), np.asarray(single["sums"]), rtol=1e-12
    )


def test_sharded_device_emit_regen_matches_single_device(setup):
    scene, compiled, cfg, tables = setup
    mesh = make_photon_mesh()
    key = jax.random.PRNGKey(9)

    sharded = shard_trace_device_emit(compiled, cfg, mesh, lanes=256)
    tallies, _ = sharded(tables, 8000, key)
    assert int(np.asarray(tallies["fates"]).sum()) == 8000

    single, _log, _counts, _steps = jax.jit(
        lambda: tracer_module.trace_bundle_device_emit(
            compiled, cfg, tables, key, 8000, lanes=256
        )
    )()
    assert_tallies_equal(tallies, single, cfg)


def test_sharded_outputs_carry_only_tallies(setup):
    """The per-lane [B, R] `seen` mask is loop state: it is neither
    returned nor all-reduced across the mesh."""
    scene, compiled, cfg, tables = setup
    mesh = make_photon_mesh()
    key = jax.random.PRNGKey(2)
    tallies, _ = shard_trace_device_emit(compiled, cfg, mesh, lanes=64)(
        tables, 800, key
    )
    assert "seen" not in tallies
    assert set(tallies) == {"distinct", "cross", "sums", "bins", "fates"}
    np.random.seed(1)
    pos, direction, wav, _src = emit_bundle(scene, 800)
    tallies, _ = shard_trace(compiled, cfg, mesh)(
        tables, pos, direction, wav, key
    )
    assert "seen" not in tallies
    assert int(np.asarray(tallies["fates"]).sum()) == 800


def test_sharded_score_tallies_match_single_device(setup):
    """The unbiased gradient estimator rides the multi-chip path:
    cfg.score compiles fate/recorder score accumulators into the sharded
    program and the shard wrappers psum-reduce them (SURVEY §2.3
    "gradient all-reduce for the differentiable path"). Integer tallies
    are bitwise equal to single-device; the float score sums agree up
    to cross-shard summation order (f64, rtol 1e-12)."""
    from pvtrace_tpu.diff.transport import resolve_pathwise_params

    scene, compiled, cfg, tables = setup
    pw = resolve_pathwise_params(compiled, [("n", "lsc")])
    score_cfg = tracer_module.make_config(
        compiled, n_rays=8000, dtype=np.float64, record_every=0,
        score=True, pathwise=pw,
    )
    mesh = make_photon_mesh()
    key = jax.random.PRNGKey(7)

    sharded = shard_trace_device_emit(compiled, score_cfg, mesh, lanes=256)
    tallies, _ = sharded(tables, 8000, key)

    single, _log, _counts, _steps = jax.jit(
        lambda: tracer_module.trace_bundle_device_emit(
            compiled, score_cfg, tables, key, 8000, lanes=256
        )
    )()
    assert_tallies_equal(tallies, single, score_cfg)
    for name in ("fate_scores", "rec_scores"):
        assert name in tallies, name  # nothing silently dropped
        np.testing.assert_allclose(
            np.asarray(tallies[name]), np.asarray(single[name]),
            rtol=1e-12, atol=1e-9, err_msg=name,
        )
    # The scene actually produced gradient signal on the mesh path.
    assert np.abs(np.asarray(tallies["fate_scores"])).max() > 0


@pytest.mark.slow
def test_fate_gradients_mesh_matches_single_device():
    """diff.transport.fate_gradients(mesh=...) — the sharded estimator —
    must reproduce the single-device estimator: fate fractions exactly
    (integer counters), score/pathwise gradients to summation order."""
    from pvtrace_tpu.diff import transport

    scene = lsc_scene()
    mesh = make_photon_mesh()
    kwargs = dict(
        seed=5, wrt="all", pathwise=[("n", "lsc")], center=True
    )
    f_single, g_single = transport.fate_gradients(scene, 8000, **kwargs)
    f_mesh, g_mesh = transport.fate_gradients(
        scene, 8000, mesh=mesh, **kwargs
    )
    for event in f_single:
        assert f_single[event] == f_mesh[event], event
        np.testing.assert_allclose(
            g_mesh[event], g_single[event], rtol=1e-10, atol=1e-12,
            err_msg=str(event),
        )
    # Pathwise channel present and non-trivial in the sharded result.
    assert any(np.abs(g_mesh[e][-1]) > 0 for e in g_mesh)


def test_fate_gradients_mesh_rejects_indivisible_batch():
    from pvtrace_tpu.diff import transport

    scene = lsc_scene()
    mesh = make_photon_mesh()
    with pytest.raises(ValueError, match="multiple of the mesh"):
        transport.fate_gradients(scene, 8001, mesh=mesh, seed=1)


@pytest.mark.slow
def test_regen_lane_width_is_bitwise_invariant(setup):
    scene, compiled, cfg, tables = setup
    key = jax.random.PRNGKey(4)

    def run(lanes):
        tallies, _l, _c, _s = jax.jit(
            lambda: tracer_module.trace_bundle_device_emit(
                compiled, cfg, tables, key, 6000, lanes=lanes
            )
        )()
        return tallies

    a = run(512)
    b = run(1024)
    c = run(None)  # full-width, no regeneration
    assert_tallies_equal(a, b, cfg)
    assert_tallies_equal(a, c, cfg)


def test_shard_simulate_host_emission_matches_single_device():
    """Scenes whose lights do NOT compile to device samplers take the
    host-bundle path in shard_simulate; with the same np.random stream
    the sharded run is bitwise equal to engine.simulate."""
    from pvtrace_tpu.parallel.shard import shard_simulate

    def custom_scene():
        world = Node(
            name="world",
            geometry=Sphere(
                radius=12.0, material=Material(refractive_index=1.0)
            ),
        )
        Node(
            name="ball",
            geometry=Sphere(
                radius=1.0, material=Material(refractive_index=1.5)
            ),
            parent=world,
        )
        light = Node(
            name="light",
            light=Light(
                wavelength=ConstantWavelengthMask(555.0),
                # A bare callable has no device sampler: host emission.
                position=lambda: (0.05, 0.0, 0.0),
            ),
            parent=world,
        )
        light.translate((0.0, 0.0, -3.0))
        return Scene(world)

    scene = custom_scene()
    compiled = engine.compile_scene(scene)
    assert not compiled.lights_supported
    mesh = make_photon_mesh()

    np.random.seed(21)
    data = shard_simulate(scene, 4000, mesh, seed=6, compiled=compiled)
    np.random.seed(21)
    result = engine.simulate(scene, 4000, seed=6, record_every=0)
    assert (data["fates"] == np.asarray(result.data["fates"])).all()
    assert int(data["fates"].sum()) == 4000


@pytest.mark.slow
def test_lsc_gradient_mesh_matches_single_device():
    """LSC.gradient(mesh=...) — the sharded unbiased estimator through
    the high-level device API — reproduces the single-device result."""
    from pvtrace_tpu.device.lsc import LSC

    def build():
        lsc = LSC((5.0, 5.0, 1.0))
        lsc.add_solar_cell({"left", "right", "near", "far"})
        return lsc

    np.random.seed(33)
    single = build().gradient(n=8000, seed=13)
    np.random.seed(33)
    sharded = build().gradient(n=8000, seed=13, mesh=make_photon_mesh())
    # Distinct counts are integers, so the efficiency ratio is exact.
    assert single["optical_efficiency"] == sharded["optical_efficiency"]
    np.testing.assert_allclose(
        sharded["gradient"], single["gradient"], rtol=1e-9, atol=1e-12
    )
    assert sharded["component"] == single["component"]


def test_shard_simulate_budget_guard():
    """The sharded entry point enforces the same uint32/int32 budget
    bounds as engine.simulate, before any compile work."""
    from pvtrace_tpu.parallel.shard import shard_simulate

    scene = lsc_scene()
    mesh = make_photon_mesh()
    with pytest.raises(ValueError, match="int32"):
        shard_simulate(scene, 2 ** 31, mesh, seed=1)
    with pytest.raises(ValueError, match="uint32"):
        shard_simulate(
            scene, 800, mesh, seed=1, index_offset=2 ** 32 - 400
        )
