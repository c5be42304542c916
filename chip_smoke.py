"""Smoke run of the device engine on one GPU, through the user entry points.

One process drives `engine.simulate`, `parallel.shard_simulate` and
`engine.simulate_checkpointed` at user scale and checks what comes out:

  slab       the benchmark slab (bench.py), 10^8-photon calls; fate counts
             against CPU reference counts at a fixed seed
  recorders  the slab with 32 facet recorders; device tallies against
             `engine.tally_histories` of the device event log
  mesh       the 24-triangle hex plate with facet overrides
             (examples/mesh_lsc.py); fate counts against CPU references
  gradients  score + pathwise gradients; d(EXIT)/dlog(dye) and d(EXIT)/dn
             against CPU references
  sharded    (--chips 4 only, and then alone) the recorder scene over a
             4-card photon mesh: integer tallies bitwise equal to one card,
             and a 4-card checkpoint resumed on one card

Exits non-zero, and prints no result, unless JAX's devices are GPUs. The
last line of stdout is {"ok": true, "device": {...}}.

    python chip_smoke.py              # one GPU
    python chip_smoke.py --chips 4    # the four-card sharded check only
"""
import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Fate slots of EngineResult.data["fates"] (light.event.Event values;
# slot 10 counts photons that left the scene without a hit).
FATE_NAMES = {4: "NONRADIATIVE", 7: "EXIT", 8: "REACT", 9: "KILL", 10: "NO_HIT"}
# Per fate, |GPU - CPU| / N. The per-photon random streams are the same
# counter-based threefry bits on both backends, so only float32 rounding
# that differs between the two compilers can re-route a photon.
FATE_TOL = 1e-3
# Recorder moment sums: float32 accumulation over the loop's steps of
# values the device computed in float32, against float64 sums of the
# logged float32 values.
MOMENT_RTOL = 1e-4

SEED = 11
PATHWISE = (("n", "lsc"),)

# CPU float32 references: the same scene, seed and budget traced by the
# CPU backend. Regenerate with
#   JAX_PLATFORMS=cpu python -c "import chip_smoke; chip_smoke.print_references()"
# `sigma_photon` is the per-photon standard deviation of each gradient
# estimator (standard error x sqrt(N)), from 8 seeds at 2^16 photons.
_SIGMA = {"d_exit_dlog_dye": 0.8579817165234684, "d_exit_dn": 17.567707921543345}
REFERENCES = {
    "slab": {
        4096: {"fates": [0, 0, 0, 0, 2694, 0, 0, 1402, 0, 0, 0]},
        2097152: {"fates": [0, 0, 0, 0, 1358415, 0, 0, 738737, 0, 0, 0]},
    },
    "mesh": {
        4096: {"fates": [0, 0, 0, 0, 1600, 0, 0, 2496, 0, 0, 0]},
        2097152: {"fates": [0, 0, 0, 0, 813065, 0, 0, 1284087, 0, 0, 0]},
    },
    "gradients": {
        4096: {
            "fates": [0, 0, 0, 0, 2694, 0, 0, 1402, 0, 0, 0],
            "d_exit_dlog_dye": 0.021799031645059586,
            "d_exit_dn": -0.132035493850708,
            "sigma_photon": _SIGMA,
        },
        2097152: {
            "fates": [0, 0, 0, 0, 1358415, 0, 0, 738737, 0, 0, 0],
            "d_exit_dlog_dye": 0.014002338983118534,
            "d_exit_dn": -0.3133544921875,
            "sigma_photon": _SIGMA,
        },
    },
}

# Check budgets exceed AUTO_LANES, so each check runs the program its
# phase timed (lane regeneration, traced budget). A budget at or below
# the lane width compiles a full-width program instead, and the mesh
# scene's took more than 17 minutes to compile on the H100.
FULL = {
    "slab": dict(n_timed=100_000_000, n_check=1 << 21),
    "recorders": dict(n_timed=10_000_000, n_check=1 << 14),
    "mesh": dict(n_timed=10_000_000, n_check=1 << 21),
    "gradients": dict(n_timed=10_000_000, n_check=1 << 21),
    "sharded": dict(n=400_000_000),
}


# ----------------------------------------------------------------------
# Scenes (the repository's own scene functions)


def slab_scene():
    sys.path.insert(0, REPO)
    from bench import build_scene

    return build_scene()


def recorder_scene(n_rec=32):
    sys.path.insert(0, REPO)
    from benchmarks.benchmark_recorders import scene_with_recorders

    return scene_with_recorders(n_rec)


def mesh_scene():
    sys.path.insert(0, os.path.join(REPO, "examples"))
    from mesh_lsc import build_mesh_lsc

    return build_mesh_lsc()


# ----------------------------------------------------------------------
# Measurement


class Phase:
    """Collects one phase's printed lines and its checks."""

    def __init__(self, name):
        import jax

        self.name = name
        self.started = time.perf_counter()
        self.ok = True
        self.compile_s = 0.0
        self.compiles = 0
        self.cache_hits = 0
        jax.monitoring.register_event_duration_secs_listener(self._on_duration)
        jax.monitoring.register_event_listener(self._on_event)

    def _on_duration(self, event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            self.compile_s += duration
        if event == "/jax/core/compile/backend_compile_duration":
            self.compiles += 1

    def _on_event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.cache_hits += 1

    def close(self):
        import jax

        jax.monitoring.unregister_event_duration_listener(self._on_duration)
        jax.monitoring.unregister_event_listener(self._on_event)

    def say(self, text):
        print(f"[{self.name}] {text}", flush=True)

    def check(self, label, observed, tolerance, ok):
        ok = bool(ok)
        self.ok &= ok
        self.say(
            f"check {label}: {observed} (tolerance {tolerance}) "
            f"{'ok' if ok else 'FAIL'}"
        )
        return ok

    def timed(self, label, n, fn, lanes):
        """Run fn() (one call that traces `n` photons and returns its
        data dict), print its rate, steps and ns per lane-step."""
        tic = time.perf_counter()
        data = fn()
        seconds = time.perf_counter() - tic
        steps = int(data["steps"])
        ns = seconds * 1e9 / max(steps * lanes, 1)
        self.say(
            f"{label}: {n} photons in {seconds:.4f} s = {n / seconds:.1f} "
            f"photons/s, steps={steps}, lanes={lanes}, "
            f"ns/lane-step={ns:.4f}"
        )
        return data, seconds

    def report_set_up(self, device):
        stats = device.memory_stats() or {}
        peak = stats.get("peak_bytes_in_use", "not available")
        self.say(
            f"compile_s={self.compile_s:.2f} (trace + lower + backend; "
            f"{self.compiles} backend compiles, {self.cache_hits} "
            f"persistent-cache hits), peak_bytes_in_use={peak}, "
            f"phase wall_s={time.perf_counter() - self.started:.1f}"
        )


def _lanes(n):
    from pvtrace_tpu.engine.api import AUTO_LANES

    return min(n, AUTO_LANES)


def _simulate(scene, n, seed, **kwargs):
    from pvtrace_tpu import engine

    kwargs.setdefault("record_every", 0)
    return engine.simulate(
        scene, n, seed=seed, dtype=np.float32, **kwargs
    ).data


def _check_fates(phase, fates, n, ref=None):
    fates = np.asarray(fates, dtype=np.int64)
    phase.check("fates sum to N", f"{int(fates.sum())} vs {n}", "exact",
                int(fates.sum()) == n)
    if ref is None:
        return
    ref = np.asarray(ref, dtype=np.int64)
    worst = 0.0
    for slot, name in FATE_NAMES.items():
        rel = abs(int(fates[slot]) - int(ref[slot])) / n
        worst = max(worst, rel)
        phase.say(f"fate {name}: device {int(fates[slot])} cpu "
                  f"{int(ref[slot])} |d|/N={rel:.3e}")
    phase.check("max per-fate |device - cpu|/N", f"{worst:.3e}",
                f"<= {FATE_TOL}", worst <= FATE_TOL)


# ----------------------------------------------------------------------
# Phases. Each takes its sizes and the reference table, so the tests can
# run it at a tiny size on the CPU.


def _timed_and_checked(phase, name, run, n_timed, n_check, refs, calls=1):
    """Warm up `run(n, seed)` (one call of the user entry point), time
    `calls` calls of n_timed photons, then compare the fates of one call
    of n_check photons at SEED with the stored CPU reference. Returns
    (last timed data, check data, reference or None)."""
    run(n_timed, 1)  # compile + warm up
    for i in range(calls):
        timed, _ = phase.timed(
            f"timed call {i + 1}", n_timed,
            lambda i=i: run(n_timed, 2 + i), _lanes(n_timed),
        )
        _check_fates(phase, timed["fates"], n_timed)
    data = run(n_check, SEED)
    ref = refs[name].get(n_check)
    phase.say(f"reference comparison at N={n_check}, seed={SEED}")
    _check_fates(phase, data["fates"], n_check,
                 None if ref is None else ref["fates"])
    phase.check("reference stored", n_check, "present", ref is not None)
    return timed, data, ref


def phase_slab(phase, n_timed, n_check, refs=REFERENCES):
    scene = slab_scene()
    _timed_and_checked(
        phase, "slab", lambda n, seed: _simulate(scene, n, seed),
        n_timed, n_check, refs, calls=2,
    )


def phase_recorders(phase, n_timed, n_check, refs=REFERENCES):
    from pvtrace_tpu import engine

    scene = recorder_scene(32)
    compiled = engine.compile_scene(scene)
    _simulate(scene, n_timed, seed=1, compiled=compiled)
    data, _ = phase.timed(
        "timed call (tallies only)", n_timed,
        lambda: _simulate(scene, n_timed, seed=2, compiled=compiled),
        _lanes(n_timed),
    )
    _check_fates(phase, data["fates"], n_timed)

    max_events = 256
    result = engine.simulate(
        scene, n_check, seed=SEED, record_every=1, dtype=np.float32,
        compiled=compiled, max_events=max_events,
    )
    longest = int(np.max(result.data["counts"]))
    phase.check("event log not truncated", f"longest history {longest}",
                f"< max_events={max_events}", longest < max_events)
    tic = time.perf_counter()
    expect = engine.tally_histories(scene, result.histories())
    phase.say(f"tally_histories over {n_check} histories took "
              f"{time.perf_counter() - tic:.1f} s on the host")
    bad_counts, bad_bins, worst = [], [], 0.0
    for name, rec in result.recorders.items():
        want = expect[name]
        if (rec.rays, rec.crossings) != (want.rays, want.crossings):
            bad_counts.append(name)
        for h in range(len(rec.spec.histograms)):
            if not np.array_equal(rec.histogram(h)[-1], want.histogram(h)[-1]):
                bad_bins.append(f"{name}[{h}]")
        scale = np.maximum(np.abs(want._moments), 1e-30)
        worst = max(worst, float(np.max(np.abs(rec._moments - want._moments)
                                        / scale)))
    n_rec = len(result.recorders)
    phase.check("recorder rays and crossings equal tally_histories",
                f"{n_rec - len(bad_counts)}/{n_rec} equal {bad_counts}",
                "exact", not bad_counts)
    phase.check("histogram bins equal tally_histories",
                f"mismatched {bad_bins}", "exact", not bad_bins)
    phase.check("moment sums vs tally_histories, max relative error",
                f"{worst:.3e}", f"<= {MOMENT_RTOL}", worst <= MOMENT_RTOL)


def phase_mesh(phase, n_timed, n_check, refs=REFERENCES):
    scene = mesh_scene()
    _timed_and_checked(
        phase, "mesh", lambda n, seed: _simulate(scene, n, seed),
        n_timed, n_check, refs,
    )


def _score_run(scene, compiled):
    """run(n, seed) -> data of one score + pathwise `engine.simulate`."""
    from pvtrace_tpu.diff.transport import resolve_pathwise_params

    pathwise = resolve_pathwise_params(compiled, PATHWISE)
    return lambda n, seed: _simulate(
        scene, n, seed, compiled=compiled, score=True, pathwise=pathwise
    )


def exit_gradients(compiled, data, n):
    """{d_exit_dlog_dye, d_exit_dn} of the plate from one score run."""
    from pvtrace_tpu.light.event import Event

    exit_row = np.asarray(data["fate_scores"], np.float64)[Event.EXIT.value]
    dye = compiled.component_names.index("dye")
    pathwise_ch = int(compiled.n_components) + len(compiled.nodes)
    return {"d_exit_dlog_dye": float(exit_row[dye] / n),
            "d_exit_dn": float(exit_row[pathwise_ch] / n)}


def phase_gradients(phase, n_timed, n_check, refs=REFERENCES):
    from pvtrace_tpu import engine

    scene = slab_scene()
    compiled = engine.compile_scene(scene)
    timed, data, ref = _timed_and_checked(
        phase, "gradients", _score_run(scene, compiled), n_timed, n_check,
        refs,
    )
    scores = np.asarray(timed["fate_scores"])
    phase.check("every fate_scores value finite",
                f"{int(np.isfinite(scores).sum())}/{scores.size}", "all",
                np.isfinite(scores).all())
    phase.say(f"gradients at N={n_timed}: "
              f"{exit_gradients(compiled, timed, n_timed)}")
    if ref is None:
        return
    # A re-routed photon swaps its contribution for a near-independent
    # one, so re-routing a fraction rho of photons moves an estimate by
    # about sqrt(2 rho) standard errors: 0.045 at rho = FATE_TOL. The
    # tolerance is five times that, a quarter of a standard error.
    for key, got in exit_gradients(compiled, data, n_check).items():
        tol = 0.25 * ref["sigma_photon"][key] / np.sqrt(n_check)
        diff = abs(got - ref[key])
        phase.check(f"{key}: device {got:.6f} cpu {ref[key]:.6f} |d|",
                    f"{diff:.3e}", f"<= {tol:.3e} (0.25 standard errors)",
                    diff <= tol)


def phase_sharded(phase, n, devices):
    """The recorder scene over a 4-card photon mesh vs one card."""
    from pvtrace_tpu import engine
    from pvtrace_tpu.parallel import make_photon_mesh, shard_simulate

    mesh = make_photon_mesh(devices)
    scene = recorder_scene(32)
    compiled = engine.compile_scene(scene)
    kwargs = dict(compiled=compiled, dtype=np.float32)
    # Compile + warm up: any budget above the lane width runs the same
    # regeneration programs as the timed calls.
    warm = min(n, 2 * len(devices) * _lanes(n))
    shard_simulate(scene, warm, mesh, seed=1, **kwargs)
    _simulate(scene, warm, seed=1, compiled=compiled)

    k = len(devices)
    sharded, t_mesh = phase.timed(
        f"{k}-card shard_simulate", n,
        lambda: shard_simulate(scene, n, mesh, seed=SEED, **kwargs),
        _lanes(n // k),
    )
    single, t_one = phase.timed(
        "1-card engine.simulate", n,
        lambda: _simulate(scene, n, seed=SEED, compiled=compiled),
        _lanes(n),
    )
    phase.say(f"{k}-card rate / 1-card rate = {t_one / t_mesh:.3f}")
    _check_fates(phase, sharded["fates"], n)

    integer = ("rec_distinct", "rec_crossings", "rec_bins", "fates")
    unequal = [key for key in integer
               if not np.array_equal(sharded[key], single[key])]
    phase.check(f"integer tallies {k}-card vs 1-card", f"unequal {unequal}",
                "bitwise", not unequal)
    phase.say(f"largest crossing counter {int(np.max(single['rec_crossings']))}"
              " (int32 counters)")
    a, b = (np.asarray(d["rec_sums"], np.float64) for d in (sharded, single))
    rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
    phase.check("moment sums, max relative difference", f"{rel:.3e}",
                f"<= {MOMENT_RTOL} (float32 sums in another order)",
                rel <= MOMENT_RTOL)

    # A run checkpointed on the mesh resumes on one card.
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        path = os.path.join(tmp, "run.npz")
        run = functools.partial(
            engine.simulate_checkpointed, scene, n, path, bundle=n // 2,
            seed=SEED, record_every=0, **kwargs,
        )
        first = run(mesh=mesh, stop_after_bundles=1)
        phase.say(f"checkpoint after 1 bundle on {k} cards: "
                  f"{first.traced}/{n} photons")
        resumed = run(mesh=None)
    pairs = (
        ("rec_distinct", resumed._distinct),
        ("rec_crossings", resumed._crossings),
        ("rec_bins", resumed._bins),
        ("fates", resumed._fates),
    )
    unequal = [key for key, got in pairs
               if not np.array_equal(got, np.asarray(single[key], np.int64))]
    phase.check(f"{k}-card checkpoint resumed on 1 card vs 1-card run",
                f"unequal {unequal}", "bitwise", not unequal)


# ----------------------------------------------------------------------
# Entry point


def _smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc.__class__.__name__})"
    return out.stdout.strip().replace("\n", " | ") or out.stderr.strip()


def _imports():
    found = {}
    for name in ("pandas", "yaml", "jsonschema"):
        try:
            __import__(name)
            found[name] = True
        except ImportError:
            found[name] = False
    return found


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chips", type=int, choices=(1, 4), default=1,
                        help="4 runs the four-card sharded check alone")
    args = parser.parse_args(argv)

    import jax

    from pvtrace_tpu.engine.api import _cache_dir

    devices = jax.devices()
    dev = devices[0]
    print(
        f"device platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devices)} nvidia-smi={_smi()!r} jax={jax.__version__} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={_cache_dir(os.environ)!r} imports={_imports()}",
        flush=True,
    )
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    if len(devices) < args.chips:
        print(f"chip_smoke: --chips {args.chips} needs {args.chips} GPUs, "
              f"JAX found {len(devices)}", file=sys.stderr)
        return 1

    if args.chips == 4:
        phases = [("sharded", functools.partial(
            phase_sharded, devices=devices[:4], **FULL["sharded"]))]
    else:
        phases = [
            ("slab", functools.partial(phase_slab, **FULL["slab"])),
            ("recorders", functools.partial(phase_recorders,
                                            **FULL["recorders"])),
            ("mesh", functools.partial(phase_mesh, **FULL["mesh"])),
            ("gradients", functools.partial(phase_gradients,
                                            **FULL["gradients"])),
        ]
    failed = []
    for name, run in phases:
        phase = Phase(name)
        try:
            run(phase)
        except Exception as exc:  # report and go on to the next phase
            import traceback

            traceback.print_exc()
            phase.say(f"FAILED: {exc.__class__.__name__}: {exc}")
            phase.ok = False
        finally:
            phase.close()
        phase.report_set_up(dev)
        if not phase.ok:
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devices)},
    }))
    return 0


def print_references(small=1 << 12, sigma_n=1 << 16, sigma_seeds=8):
    """Recompute REFERENCES on the CPU backend (float32) and print them."""
    import jax

    assert jax.devices()[0].platform == "cpu", "references come from the CPU"
    assert not jax.config.read("jax_enable_x64")
    from pvtrace_tpu import engine

    def sizes(name):
        return (small, FULL[name]["n_check"])

    out = {"slab": {}, "mesh": {}, "gradients": {}}
    for name, build in (("slab", slab_scene), ("mesh", mesh_scene)):
        for n in sizes(name):
            out[name][n] = {"fates": _simulate(build(), n, SEED)["fates"].tolist()}
    scene = slab_scene()
    compiled = engine.compile_scene(scene)
    run = _score_run(scene, compiled)
    spread = [exit_gradients(compiled, run(sigma_n, 100 + s), sigma_n)
              for s in range(sigma_seeds)]
    sigma = {key: float(np.std([g[key] for g in spread], ddof=1)
                        * np.sqrt(sigma_n)) for key in spread[0]}
    for n in sizes("gradients"):
        data = run(n, SEED)
        out["gradients"][n] = {"fates": data["fates"].tolist(),
                               **exit_gradients(compiled, data, n),
                               "sigma_photon": sigma}
    print(repr(out))
    return out


if __name__ == "__main__":
    sys.exit(main())
