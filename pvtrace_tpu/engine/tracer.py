"""The device wavefront tracer — the heart of the framework.

Wavefront re-design of the reference's per-ray native kernel
(``engine/_kernel.pyx:603-897``): the whole photon bundle advances in
lockstep as structure-of-arrays state inside a ``lax.while_loop``; every
branch of the per-ray event loop is a masked ``where``; per-ray xoshiro
streams become per-photon ``jax.random.fold_in`` keys (bitwise
reproducible regardless of batch sharding).

Design decisions (taken for the accelerator the engine was first
written for; ROADMAP Speed 4-5 re-measures them on the GPU):

* **Few gathers.** The scene structure (node count, geometry types,
  component wiring, surfaces, facet overrides) is *static*, so the step
  is code-generated per scene: geometry params, rigid transforms and
  material scalars are baked in as compile-time constants, and all
  per-node / per-component "table lookups" become short unrolled
  ``where`` chains.
* The only true gathers are the two wavelength-dependent ones, packed
  into single wide rows by the compiler (``spec_pack``: cumulative
  attenuation + pre-shifted emission CDFs in one [B, 2W] gather;
  ``ems_icdf_pairs``: inverse-CDF emission sampling in one [B, 2]
  gather, executed under ``lax.cond`` only on steps where a photon
  actually emits).
* Trig-free optics: Fresnel from cos(theta), phase sampling via
  (sin, cos) identities — no arccos/arcsin in the hot path. The
  incidence angle is materialised only when recorders need it.
* State is flat [B] component arrays (never [B, 3] / [B, N, k]), so
  every elementwise op runs on full-width vectors.

Event semantics replicate ``photon_tracer.step_forward`` event-for-event:
container = unique-forward-hit node nearest the origin, EXIT on hitting
the root, exponential free path vs boundary distance, component roulette
proportional to attenuation, quantum-yield coin flip, emission-CDF
inverse sampling with kT/redshift truncation, Fresnel/null surface
branch with per-facet overrides, KILL on step/budget caps.

The loop terminates as soon as every photon is dead, so a bundle costs
~(longest-lived photon) steps, not ``maxsteps``.
"""
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Diagnostic ablations (perf bisection only — physics becomes WRONG):
# PVTRACE_TPU_ABLATE may contain "rng" (hash instead of threefry draws)
# and/or "gather" (constant spectral rows instead of table gathers).
_ABLATE = os.environ.get("PVTRACE_TPU_ABLATE", "")


# ----------------------------------------------------------------------
# Flat counter-based RNG.
#
# jax.random's vmapped per-lane keys store state as [B, 2] and draws as
# [B, 8]; the same threefry2x32 generator (bit-exact, verified against
# jax._src.prng.threefry_2x32) runs here on flat [B] word arrays, which
# keeps the RNG in the same full-width elementwise fusions as the rest
# of the step. Streams are labelled by counters:
#
#   photon key  (pk0, pk1) = threefry(seed, pid, 0)
#   step draws  u[2j], u[2j+1] = threefry(pk, count, j), j = 0..3
#   emission    e[2j], e[2j+1] = threefry(pk, 0, 16 + j)
#
# Every draw is a pure function of (seed, photon id, the photon's own
# step counter), preserving the bitwise lane-width/sharding invariance.


def _rotl32(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 (20 rounds), identical bits to jax's generator."""
    ks2 = k0 ^ k1 ^ np.uint32(0x1BD11BDA)
    ks = (k0, k1, ks2)
    x0 = c0 + ks[0]
    x1 = c1 + ks[1]
    for r in range(5):
        for rot in _THREEFRY_ROT[r % 2]:
            x0 = x0 + x1
            x1 = _rotl32(x1, rot)
            x1 = x1 ^ x0
        x0 = x0 + ks[(r + 1) % 3]
        x1 = x1 + ks[(r + 2) % 3] + np.uint32(r + 1)
    return x0, x1


def _uniform32(bits, f):
    """Uniform in [0, 1) from 32 random bits (jax's construction)."""
    fbits = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    return jax.lax.bitcast_convert_type(fbits, jnp.float32).astype(f) - 1.0


def _draw8(pk0, pk1, counter, f):
    """Eight uniforms per lane from the photon key + step counter."""
    out = []
    for j in range(4):
        c1 = jnp.full_like(counter, j)
        w0, w1 = _threefry2x32(pk0, pk1, counter, c1)
        out.append(_uniform32(w0, f))
        out.append(_uniform32(w1, f))
    return out


def _key_words(base_key):
    data = jax.random.key_data(base_key).astype(jnp.uint32)
    return data[..., 0], data[..., 1]

def _clenshaw(t, coef):
    """Evaluate a Chebyshev series at t in [-1, 1] (Clenshaw recurrence).

    Coefficients are baked in as program constants, so the whole
    evaluation is a chain of fused multiply-adds — the gather-free
    spectral path (see CompiledScene._fit_chebyshev)."""
    b1 = jnp.zeros_like(t)
    b2 = b1
    for k in range(len(coef) - 1, 0, -1):
        b1, b2 = 2.0 * t * b1 - b2 + float(coef[k]), b1
    return t * b1 - b2 + float(coef[0])


def _eval_fit(t, fit):
    """Evaluate a compiler fit descriptor (kind, coef, offset) at t.

    "lin": plain Chebyshev series; "log": exp(series) - offset (the
    log-space surrogate for cliff-and-plateau attenuation spectra);
    "pw": adaptive piecewise fit — every segment's short Clenshaw chain
    is independent (ILP across segments), masks select the lane's own
    segment, and at most ONE exp is spent on all log segments combined.
    See CompiledScene._cheb_fit."""
    kind, coef, off = fit
    if kind == "pw":
        segs = coef
        vlin = jnp.zeros_like(t)
        vlog = None
        mlog = None
        last = len(segs) - 1
        for i, (a, b, k, c) in enumerate(segs):
            # Clamp: lanes outside the segment would otherwise evaluate
            # Clenshaw at |ts| up to ~2/(b-a), which can overflow f32
            # and poison reverse-mode gradients through the jnp.where.
            ts = jnp.clip((t - a) * (2.0 / (b - a)) - 1.0, -1.0, 1.0)
            vs = _clenshaw(ts, c)
            if last == 0:
                m = jnp.ones(t.shape, bool)
            elif i == 0:
                m = t < b
            elif i == last:
                m = t >= a
            else:
                m = (t >= a) & (t < b)
            if k == "log":
                vlog = vs if vlog is None else jnp.where(m, vs, vlog)
                mlog = m if mlog is None else (mlog | m)
            else:
                vlin = jnp.where(m, vs, vlin)
        if vlog is None:
            return vlin
        return jnp.where(mlog, jnp.exp(vlog) - float(off), vlin)
    v = _clenshaw(t, coef)
    if kind == "log":
        v = jnp.exp(v) - float(off)
    return v


def _fresnel_R_scalar(n1, n2, c1):
    """Unpolarised Fresnel reflectivity as a smooth scalar function of
    the two refractive indices and the incidence cosine — kept separate
    so its exact partials come from autodiff (see the score block)."""
    s2 = jnp.clip(1.0 - c1 * c1, 0.0, 1.0)
    ratio = n1 / n2
    under = jnp.clip(1.0 - ratio * ratio * s2, 0.0, None)
    k = jnp.sqrt(under)
    rs = ((n1 * c1 - n2 * k) / (n1 * c1 + n2 * k)) ** 2
    rp = ((n1 * k - n2 * c1) / (n1 * k + n2 * c1)) ** 2
    return 0.5 * (rs + rp)


_fresnel_dR = jax.vmap(jax.grad(_fresnel_R_scalar, argnums=(0, 1)))


from pvtrace_tpu.engine import compiler as comp

# Matches the reference kernel's constants (_kernel.pyx:29-34)
ALPHA_ZERO = 1e-8
C_CM_PER_S = 2.99792458e10
KB_EV = 1.380649e-23 / 1.60217662e-19

# Event ids (light.event.Event values)
EV_GENERATE, EV_REFLECT, EV_TRANSMIT, EV_ABSORB = 0, 1, 2, 3
EV_NONRADIATIVE, EV_SCATTER, EV_EMIT, EV_EXIT, EV_REACT, EV_KILL = 4, 5, 6, 7, 8, 9
FATE_NO_HIT = 10  # extra fate-counter slot: ray left scene without hits
N_FATES = 11

# Recorder selector ids (engine.recorder.EVENTS values)
REC_ENTERING, REC_ESCAPING, REC_REFLECTED = 0, 1, 2
REC_LOST, REC_REACTED, REC_KILLED, REC_EXIT = 3, 4, 5, 6
SEL_NONE = -1

OVR_MIRROR, OVR_ABSORB, OVR_LAMBERTIAN = 0, 1, 2

_INF = float(np.inf)


class TraceConfig(NamedTuple):
    """Static (hashable) compile-time configuration."""

    n_nodes: int
    root_id: int
    n_recorders: int
    hist_specs: tuple
    total_bins: int
    grid_x0: float
    grid_dx: float
    grid_n: int
    icdf_n: int
    n_lum: int
    eps: tuple  # per-node forward-hit tolerance
    maxsteps: int
    max_events: int
    n_slots: int
    record_every: int
    emit_method: int
    dtype: type
    score: bool = False
    n_comps: int = 0
    maxpathlength: float = _INF
    # Pathwise score channels: ("n", node) differentiates w.r.t. a
    # node's refractive index (full hybrid estimator: Fresnel-coin
    # likelihood WITH the Snell/incidence tangent term, plus free-flight
    # survival); ("geom", node, param_index) w.r.t. a geometry parameter
    # (box size / sphere radius / cylinder length-radius).
    pathwise: tuple = ()


def make_config(compiled, n_rays, dtype=np.float32, maxsteps=1000,
                max_events=128, record_every=1, emit_method="kT",
                score=False, maxpathlength=None, pathwise=()):
    if record_every > 0:
        n_slots = (n_rays + record_every - 1) // record_every
    else:
        n_slots = 0
    return TraceConfig(
        n_nodes=len(compiled.nodes),
        root_id=compiled.root_id,
        n_recorders=compiled.n_recorders,
        hist_specs=tuple(tuple(h) for h in compiled.hist_specs),
        total_bins=compiled.total_bins,
        grid_x0=compiled.grid_x0,
        grid_dx=compiled.grid_dx,
        grid_n=compiled.grid_n,
        icdf_n=compiled.icdf_n,
        n_lum=compiled.n_lum,
        eps=compiled.resolved_eps_per_node(dtype),
        maxsteps=int(maxsteps),
        max_events=int(max_events),
        n_slots=n_slots,
        record_every=int(record_every),
        emit_method=comp.EMIT_METHODS[emit_method]
        if isinstance(emit_method, str)
        else int(emit_method),
        dtype=np.dtype(dtype).type,
        score=bool(score),
        n_comps=int(compiled.n_components),
        maxpathlength=(
            _INF if maxpathlength is None else float(maxpathlength)
        ),
        pathwise=tuple(tuple(p) for p in pathwise),
    )


# ----------------------------------------------------------------------
# Small static helpers (python-level codegen over the scene structure)


def _select(index_array, values, init):
    """Unrolled one-hot select: values[i] where index_array == i."""
    acc = init
    for i, v in enumerate(values):
        acc = jnp.where(index_array == i, v, acc)
    return acc


def _member(index_array, members):
    """Boolean mask: index_array in static set `members`."""
    if not members:
        return jnp.zeros(index_array.shape, dtype=bool)
    acc = index_array == members[0]
    for m in members[1:]:
        acc = acc | (index_array == m)
    return acc


def _intersect_node_static(gtype, params, o, d, eps):
    """Forward hits of one node's geometry (static type + params).

    o, d: component triples of local-frame ray. Returns list of
    (t, valid) candidate pairs replicating _kernel.pyx:245-356 filters.
    """
    ox, oy, oz = o
    dx, dy, dz = d
    if gtype == comp.GEOM_BOX:
        hx, hy, hz = 0.5 * params[0], 0.5 * params[1], 0.5 * params[2]
        tmin = jnp.full_like(ox, -_INF)
        tmax = jnp.full_like(ox, _INF)
        miss = jnp.zeros(ox.shape, dtype=bool)
        for oo, dd, h in ((ox, dx, hx), (oy, dy, hy), (oz, dz, hz)):
            par = jnp.abs(dd) < 1e-30
            inv = 1.0 / jnp.where(par, 1.0, dd)
            t1 = (-h - oo) * inv
            t2 = (h - oo) * inv
            lo = jnp.minimum(t1, t2)
            hi = jnp.maximum(t1, t2)
            lo = jnp.where(par, -_INF, lo)
            hi = jnp.where(par, _INF, hi)
            miss = miss | (par & ((oo < -h) | (oo > h)))
            tmin = jnp.maximum(tmin, lo)
            tmax = jnp.minimum(tmax, hi)
        ok = (tmax >= tmin) & ~miss
        return [(tmin, ok & (tmin > eps)), (tmax, ok & (tmax > eps))]
    if gtype == comp.GEOM_SPHERE:
        radius = params[0]
        a = dx * dx + dy * dy + dz * dz
        b = 2.0 * (dx * ox + dy * oy + dz * oz)
        c = ox * ox + oy * oy + oz * oz - radius * radius
        disc = b * b - 4.0 * a * c
        ok = disc >= 0.0
        sq = jnp.sqrt(jnp.where(ok, disc, 0.0))
        t1 = (-b - sq) / (2.0 * a)
        t2 = (-b + sq) / (2.0 * a)
        return [(t1, ok & (t1 > eps)), (t2, ok & (t2 > eps))]
    # Capped cylinder
    length, radius = params[0], params[1]
    half = 0.5 * length
    a = dx * dx + dy * dy
    hasb = a > 1e-30
    sa = jnp.where(hasb, a, 1.0)
    b = 2.0 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - radius * radius
    disc = b * b - 4.0 * a * c
    ok = hasb & (disc >= 0.0)
    sq = jnp.sqrt(jnp.where(disc >= 0.0, disc, 0.0))
    tb1 = (-b - sq) / (2.0 * sa)
    tb2 = (-b + sq) / (2.0 * sa)
    zb1 = oz + tb1 * dz
    zb2 = oz + tb2 * dz
    out = [
        (tb1, ok & (zb1 > -half) & (zb1 < half) & (tb1 > eps)),
        (tb2, ok & (zb2 > -half) & (zb2 < half) & (tb2 > eps)),
    ]
    hasc = jnp.abs(dz) > 1e-30
    sdz = jnp.where(hasc, dz, 1.0)
    for zcap in (-half, half):
        t = (zcap - oz) / sdz
        r2 = (ox + t * dx) ** 2 + (oy + t * dy) ** 2
        out.append((t, hasc & (r2 <= radius * radius) & (t > eps)))
    return out


def _mesh_nearest_two(mesh_consts, o, d, eps):
    """Nearest-two forward hits of a triangle mesh for every lane.

    Möller–Trumbore over a fixed-trip `fori_loop` (runtime O(T), graph
    O(1)); mirrors the per-ray oracle's tolerances
    (geometry/mesh.py:107-126). Returns (t1, t2, count, first-hit
    face normal) — unlike the oracle there is no shared-edge hit
    dedup, a measure-zero event for Monte-Carlo rays.
    """
    V0h, E1h, E2h, FNh = (np.asarray(a) for a in mesh_consts)
    ox, oy, oz = o
    dxv, dyv, dzv = d
    T = V0h.shape[0]
    inf = jnp.full_like(ox, _INF)
    # Small meshes unroll with scalar program constants: a traced
    # fori_loop keeps XLA from fusing the per-triangle bodies (each trip
    # gathers its constants dynamically). Big meshes keep the
    # O(1)-program fori_loop. The threshold is re-measured on the GPU
    # under ROADMAP Speed 6.
    unroll = T <= 96
    if not unroll:
        V0 = jnp.asarray(V0h)
        E1 = jnp.asarray(E1h)
        E2 = jnp.asarray(E2h)
        FN = jnp.asarray(FNh)

    def tri(t, carry):
        t1, t2, cnt, nx, ny, nz = carry
        if unroll:
            a0, a1, a2 = (float(V0h[t, i]) for i in range(3))
            e10, e11, e12 = (float(E1h[t, i]) for i in range(3))
            e20, e21, e22 = (float(E2h[t, i]) for i in range(3))
            fn0, fn1, fn2 = (float(FNh[t, i]) for i in range(3))
        else:
            a0, a1, a2 = V0[t, 0], V0[t, 1], V0[t, 2]
            e10, e11, e12 = E1[t, 0], E1[t, 1], E1[t, 2]
            e20, e21, e22 = E2[t, 0], E2[t, 1], E2[t, 2]
            fn0, fn1, fn2 = FN[t, 0], FN[t, 1], FN[t, 2]
        pvx = dyv * e22 - dzv * e21
        pvy = dzv * e20 - dxv * e22
        pvz = dxv * e21 - dyv * e20
        det = e10 * pvx + e11 * pvy + e12 * pvz
        ok = jnp.abs(det) > 1e-14
        inv = 1.0 / jnp.where(ok, det, 1.0)
        tvx = ox - a0
        tvy = oy - a1
        tvz = oz - a2
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
        qvx = tvy * e12 - tvz * e11
        qvy = tvz * e10 - tvx * e12
        qvz = tvx * e11 - tvy * e10
        v = (dxv * qvx + dyv * qvy + dzv * qvz) * inv
        th = (e20 * qvx + e21 * qvy + e22 * qvz) * inv
        hit = (
            ok & (u >= -1e-12) & (v >= -1e-12)
            & (u + v <= 1.0 + 1e-12) & (th > eps)
        )
        tv = jnp.where(hit, th, _INF)
        isfirst = tv < t1
        issecond = ~isfirst & (tv < t2)
        t2 = jnp.where(isfirst, t1, jnp.where(issecond, tv, t2))
        nx = jnp.where(isfirst, fn0, nx)
        ny = jnp.where(isfirst, fn1, ny)
        nz = jnp.where(isfirst, fn2, nz)
        t1 = jnp.where(isfirst, tv, t1)
        cnt = cnt + hit.astype(jnp.int32)
        return (t1, t2, cnt, nx, ny, nz)

    init = (
        inf, inf, jnp.zeros(ox.shape, jnp.int32),
        jnp.zeros_like(ox), jnp.zeros_like(ox), jnp.ones_like(ox),
    )
    if unroll:
        carry = init
        for t in range(T):
            carry = tri(t, carry)
        return carry
    return jax.lax.fori_loop(0, T, tri, init)


def _local_normal_static(gtype, params, p):
    """Outward local normal triple at local point triple `p` for a
    static geometry (kernel local_normal, _kernel.pyx:359-400)."""
    px, py, pz = p
    if gtype == comp.GEOM_BOX:
        hx, hy, hz = 0.5 * params[0], 0.5 * params[1], 0.5 * params[2]
        # Face order (x,-),(x,+),(y,-),(y,+),(z,-),(z,+), first-min wins
        faces = (
            (jnp.abs(px + hx), (-1.0, 0.0, 0.0)),
            (jnp.abs(px - hx), (1.0, 0.0, 0.0)),
            (jnp.abs(py + hy), (0.0, -1.0, 0.0)),
            (jnp.abs(py - hy), (0.0, 1.0, 0.0)),
            (jnp.abs(pz + hz), (0.0, 0.0, -1.0)),
            (jnp.abs(pz - hz), (0.0, 0.0, 1.0)),
        )
        best, (nx, ny, nz) = faces[0][0], [
            jnp.full_like(px, v) for v in faces[0][1]
        ]
        for dist, (vx, vy, vz) in faces[1:]:
            closer = dist < best
            nx = jnp.where(closer, vx, nx)
            ny = jnp.where(closer, vy, ny)
            nz = jnp.where(closer, vz, nz)
            best = jnp.minimum(best, dist)
        return nx, ny, nz
    if gtype == comp.GEOM_SPHERE:
        mag = jnp.sqrt(px * px + py * py + pz * pz)
        mag = jnp.where(mag == 0.0, 1.0, mag)
        return px / mag, py / mag, pz / mag
    length = params[0]
    half = 0.5 * length
    atol = 1e-8 + 1e-5 * abs(half)
    bottom = jnp.abs(pz + half) <= atol
    top = jnp.abs(pz - half) <= atol
    r = jnp.sqrt(px * px + py * py)
    sr = jnp.where(r == 0.0, 1.0, r)
    nx = jnp.where(bottom | top, 0.0, px / sr)
    ny = jnp.where(bottom | top, 0.0, py / sr)
    nz = jnp.where(bottom, -1.0, jnp.where(top, 1.0, 0.0))
    return nx, ny, nz


# ----------------------------------------------------------------------
# Event log (validation path; no-op when record_every == 0)


# Event-log layout: two packed arrays so each _record call costs ONE
# int scatter + ONE float scatter instead of 12 per-field scatters (the
# log path only runs in validation/debug runs with record_every > 0).
_LOG_INTS = ("kind", "hit", "container", "adjacent", "component", "source")
_LOG_VECS = ("position", "direction", "normal")  # floats[..., 0:9]
_LOG_SCALARS = ("wavelength", "travelled", "duration")  # floats[..., 9:12]


def _empty_log(cfg):
    S = cfg.n_slots + 1
    E = cfg.max_events
    return {
        "ints": jnp.full((S, E, len(_LOG_INTS)), -1, dtype=jnp.int32),
        "floats": jnp.zeros((S, E, 12), dtype=cfg.dtype),
    }


def _record(log, nevents, slot, mask, cfg, *, kind, hit, container, adjacent,
            component, source, pos3, dir3, normal3, wavelength, travelled,
            duration):
    if cfg.n_slots == 0:
        return log, nevents
    S = cfg.n_slots
    E = cfg.max_events
    write = mask & (slot < S) & (nevents < E)
    row = jnp.where(write, slot, S)
    col = jnp.clip(nevents, 0, E - 1)
    B = mask.shape[0]

    as_i = lambda v: jnp.broadcast_to(jnp.asarray(v, jnp.int32), (B,))
    as_f = lambda v: jnp.broadcast_to(jnp.asarray(v, cfg.dtype), (B,))
    ints = jnp.stack(
        [as_i(v) for v in (kind, hit, container, adjacent, component, source)],
        axis=-1,
    )
    zero3 = jnp.zeros((B, 3), cfg.dtype)
    floats = jnp.concatenate(
        [
            pos3.astype(cfg.dtype),
            dir3.astype(cfg.dtype),
            (normal3 if normal3 is not None else zero3).astype(cfg.dtype),
            jnp.stack(
                [as_f(v) for v in (wavelength, travelled, duration)], axis=-1
            ),
        ],
        axis=-1,
    )
    out = dict(log)
    cur_i = log["ints"][row, col]
    out["ints"] = log["ints"].at[row, col].set(
        jnp.where(write[:, None], ints, cur_i)
    )
    cur_f = log["floats"][row, col]
    out["floats"] = log["floats"].at[row, col].set(
        jnp.where(write[:, None], floats, cur_f)
    )
    return out, nevents + write.astype(jnp.int32)


# ----------------------------------------------------------------------
# Tallies


def _empty_tallies(cfg, B):
    R = max(cfg.n_recorders, 1)
    out = {
        "distinct": jnp.zeros(R, dtype=jnp.int32),
        "cross": jnp.zeros(R, dtype=jnp.int32),
        "sums": jnp.zeros((R, 8), dtype=cfg.dtype),
        "bins": jnp.zeros(cfg.total_bins + 1, dtype=jnp.int32),
        "seen": jnp.zeros((B, R), dtype=bool),
        "fates": jnp.zeros(N_FATES, dtype=jnp.int32),
    }
    if cfg.score:
        # Score-function (likelihood-ratio) accumulators. Channel
        # layout: [0, n_comps) are d log p(path) / d log(scale_c) per
        # component; [n_comps, n_comps + n_nodes) are d log p(path) /
        # d n_k per node refractive index (Fresnel coin probabilities
        # only); [n_comps + n_nodes, ...) are the requested pathwise
        # hybrid channels (cfg.pathwise), one per parameter.
        # d(fate fraction)/d theta is fate_scores[fate, ch] / num_rays.
        ch = cfg.n_comps + cfg.n_nodes + len(cfg.pathwise)
        out["fate_scores"] = jnp.zeros((N_FATES, ch), dtype=cfg.dtype)
        if cfg.n_recorders > 0:
            # Same estimator per recorder: the path score at a photon's
            # FIRST matching interaction gives d(distinct fraction)/d
            # theta — draws after the claim cannot change membership.
            out["rec_scores"] = jnp.zeros(
                (cfg.n_recorders, ch), dtype=cfg.dtype
            )
    return out


def _tally(tallies, compiled, cfg, sel, tnode, have_normal, wnormal3, lpos3,
           angle, wavelength, travelled, duration, score=None):
    """Accumulate one (optional) interaction per photon into matching
    recorders (kernel tally, _kernel.pyx:501-556).

    Vectorized over the recorder axis: one [B, R] match matrix, one-pass
    axis reductions for counts, and matmuls for the moment/score
    sums — program size and step cost stay flat as R grows to the
    256-recorder ceiling (the reference's cap, engine/compiler.py:23)
    instead of emitting R unrolled reduce+scatter chains. Histogram
    binning stays a per-spec loop (each histogram has its own axes);
    cost is O(#histograms), not O(R^2).
    """
    R = cfg.n_recorders
    seen0 = tallies["seen"]
    rec_scores = tallies.get("rec_scores") if score is not None else None

    rn = jnp.asarray(compiled.rec_node[:R], jnp.int32)
    rev = jnp.asarray(compiled.rec_event[:R], jnp.int32)
    m = (tnode[:, None] == rn[None, :]) & (sel[:, None] == rev[None, :])
    if np.any(compiled.rec_has_facet[:R]):
        hf = jnp.asarray(compiled.rec_has_facet[:R] != 0)
        facet = np.asarray(compiled.rec_facet[:R], dtype=cfg.dtype)
        atol = jnp.asarray(compiled.rec_atol[:R], cfg.dtype)[None, :]
        fm = have_normal[:, None]
        for axis in range(3):
            fm = fm & (
                jnp.abs(wnormal3[axis][:, None] - facet[None, :, axis])
                <= atol
            )
        m = m & (fm | ~hf[None, :])

    new = m & ~seen0
    newf = new.astype(cfg.dtype)
    cross = tallies["cross"] + jnp.sum(m, axis=0, dtype=jnp.int32)
    distinct = tallies["distinct"] + jnp.sum(new, axis=0, dtype=jnp.int32)
    seen = seen0 | m
    props8 = jnp.stack(
        [
            wavelength, wavelength * wavelength,
            angle, angle * angle,
            duration, duration * duration,
            travelled, travelled * travelled,
        ],
        axis=-1,
    )
    # Full-precision matmuls: by default a float32 matmul may run in
    # TF32 on a GPU (about three decimal digits), which would corrupt
    # wavelength^2-scale moments.
    sums = tallies["sums"] + jnp.matmul(
        newf.T, props8, precision=jax.lax.Precision.HIGHEST
    )
    if rec_scores is not None:
        rec_scores = rec_scores + jnp.matmul(
            newf.T, score.T, precision=jax.lax.Precision.HIGHEST
        )

    bins = tallies["bins"]
    props = {
        0: wavelength, 1: angle, 2: duration, 3: travelled,
        4: lpos3[0], 5: lpos3[1], 6: lpos3[2],
    }
    # Histogram binning WITHOUT scatters (a [B]-wide scatter-add per
    # spec was the slow path on the engine's first accelerator; ROADMAP
    # Speed 4 compares the two on the GPU). Each spec builds a one-hot
    # bin matrix and reduces it with a matmul:
    #   1D:      counts[k]    = sum_b mask[b] * onehot_a[b, k]
    #   heatmap: counts[j, k] = sum_b (mask*onehot_a)[b, j] * onehot_b[b, k]
    # and the result lands in the flat bins array via a STATIC slice
    # add. bf16 one-hot inputs with f32 accumulation are exact (values
    # are 0/1; counts < 2^24).
    #
    # Specs sharing a bin axis (same property, range, count — e.g. 128
    # facet recorders all histogramming wavelength on [400, 800, 50])
    # are BATCHED: one unmasked one-hot build, the per-spec masks pulled
    # from the [B, R] `new` matrix already computed above, and ONE
    # [G, B] x [B, n] contraction for the whole group instead of G
    # skinny [1, B] matmuls. The recorder mask rides the
    # contraction, so the one-hot only folds out-of-range values to a
    # dropped column.
    def onehot(values, lo, hi, n_bins):
        idx = jnp.floor((values - lo) / (hi - lo) * n_bins).astype(jnp.int32)
        ok = (idx >= 0) & (idx < n_bins)
        idx = jnp.where(ok, idx, n_bins)  # out-of-range -> dropped column
        hot = idx[:, None] == jnp.arange(n_bins, dtype=jnp.int32)[None, :]
        return hot.astype(jnp.bfloat16)

    new_bf = None  # [B, R] new-interaction matrix in bf16, built lazily
    groups_1d = {}
    specs_2d = []
    for spec in cfg.hist_specs:
        (r, prop_a, prop_b, na, nb, lo_a, hi_a, lo_b, hi_b, offset) = spec
        if prop_b < 0:
            axis = (prop_a, lo_a, hi_a, na)
            groups_1d.setdefault(axis, []).append((r, offset))
        else:
            specs_2d.append(spec)

    for (prop_a, lo_a, hi_a, na), members in groups_1d.items():
        hot_a = onehot(props[prop_a], lo_a, hi_a, na)
        if len(members) == 1:
            r, offset = members[0]
            masked = new[:, r].astype(jnp.bfloat16)
            counts = jnp.matmul(
                masked[None, :], hot_a, preferred_element_type=jnp.float32
            )
            bins = bins.at[offset:offset + na].add(
                counts[0].astype(bins.dtype)
            )
            continue
        if new_bf is None:
            new_bf = new.astype(jnp.bfloat16)
        rows = np.asarray([r for r, _ in members], dtype=np.int32)
        counts = jnp.matmul(
            new_bf[:, rows].T, hot_a, preferred_element_type=jnp.float32
        )  # [G, na]
        offsets = [offset for _r, offset in members]
        if offsets == list(range(offsets[0], offsets[0] + na * len(members),
                                 na)):
            # Same-shaped specs get consecutive offsets from the
            # compiler: land the whole group in ONE static slice add.
            bins = bins.at[offsets[0]:offsets[0] + na * len(members)].add(
                counts.ravel().astype(bins.dtype)
            )
        else:
            for i, (_r, offset) in enumerate(members):
                bins = bins.at[offset:offset + na].add(
                    counts[i].astype(bins.dtype)
                )

    hot_cache = {}
    for (r, prop_a, prop_b, na, nb, lo_a, hi_a, lo_b, hi_b,
         offset) in specs_2d:
        new_r = new[:, r]
        # Share the unmasked one-hot across heatmaps on the same axes;
        # the per-recorder mask folds into the left factor.
        key_a = (prop_a, lo_a, hi_a, na)
        hot_a = hot_cache.get(key_a)
        if hot_a is None:
            hot_a = hot_cache[key_a] = onehot(props[prop_a], lo_a, hi_a, na)
        key_b = (prop_b, lo_b, hi_b, nb)
        hot_b = hot_cache.get(key_b)
        if hot_b is None:
            hot_b = hot_cache[key_b] = onehot(props[prop_b], lo_b, hi_b, nb)
        masked_a = hot_a * new_r[:, None].astype(jnp.bfloat16)
        counts = jnp.matmul(
            masked_a.T, hot_b, preferred_element_type=jnp.float32
        ).ravel()
        bins = bins.at[offset:offset + na * nb].add(counts.astype(bins.dtype))
    out = dict(tallies)
    out["seen"] = seen
    out["distinct"] = distinct
    out["cross"] = cross
    out["sums"] = sums
    out["bins"] = bins
    if rec_scores is not None:
        out["rec_scores"] = rec_scores
    return out


# ----------------------------------------------------------------------
# The trace loop


def _photon_keys(base_key, B, index_offset):
    photon_ids = jnp.asarray(index_offset, jnp.uint32) + jnp.arange(
        B, dtype=jnp.uint32
    )
    s0, s1 = _key_words(base_key)
    pk0, pk1 = _threefry2x32(s0, s1, photon_ids, jnp.zeros_like(photon_ids))
    return photon_ids, (pk0, pk1)


def _device_emit_flat(compiled, cfg, tables, keys, photon_ids):
    """Sample the initial bundle on device from the compiled light
    sources (static samplers; emission counter stream). Counterpart of
    the host bundle emission (engine/emit.py) with zero host work.

    Shape-agnostic (B is the input's shape tuple) and returns unstacked
    component triples so callers can consume tiled state without
    relayouts. `tables` may be None when every light is
    constant-wavelength or has a Chebyshev-fitted spectrum."""
    f = cfg.dtype
    B = photon_ids.shape
    M = cfg.icdf_n
    pk0, pk1 = keys
    zero_c = jnp.zeros(B, jnp.uint32)
    u = []
    for j in range(3):
        w0, w1 = _threefry2x32(
            pk0, pk1, zero_c, jnp.full(B, 16 + j, jnp.uint32)
        )
        u.append(_uniform32(w0, f))
        u.append(_uniform32(w1, f))
    lights = compiled.light_static
    n_lights = len(lights)
    light_id = (photon_ids % n_lights).astype(jnp.int32)

    px = jnp.zeros(B, f)
    py = jnp.zeros(B, f)
    pz = jnp.zeros(B, f)
    dxv = jnp.zeros(B, f)
    dyv = jnp.zeros(B, f)
    dzv = jnp.ones(B, f)
    wav = jnp.full(B, 555.0, f)
    C = comp.CompiledScene

    for li, (wspec, pspec, dspec, matrix) in enumerate(lights):
        here = light_id == li if n_lights > 1 else jnp.ones(B, bool)
        # wavelength
        if wspec[0] == C.WAV_CONST:
            w_l = jnp.full(B, wspec[1], f)
        else:
            row = int(wspec[1])
            cheb_light = getattr(compiled, "cheb_light_icdf", None)
            if cheb_light is not None and not bool(
                os.environ.get("PVTRACE_TPU_NO_CHEB", "")
            ):
                w_l = _eval_fit(2.0 * u[0] - 1.0, cheb_light[row])
            else:
                gpos = u[0] * (M - 1)
                j0 = jnp.clip(gpos.astype(jnp.int32), 0, M - 2)
                gfrac = gpos - j0.astype(f)
                pair = tables["light_icdf_pairs"][row * M + j0]
                w_l = pair[:, 0] + gfrac * (pair[:, 1] - pair[:, 0])
        # position (local frame)
        kind = pspec[0]
        if kind == C.POS_DEFAULT:
            lx = jnp.zeros(B, f)
            ly = jnp.zeros(B, f)
            lz = jnp.zeros(B, f)
        elif kind == C.POS_RECT:
            lx = (2.0 * u[1] - 1.0) * pspec[1]
            ly = (2.0 * u[2] - 1.0) * pspec[2]
            lz = jnp.zeros(B, f)
        elif kind == C.POS_CIRCLE:
            r = jnp.sqrt(u[1]) * pspec[1]
            ang = 2.0 * np.pi * u[2]
            lx = r * jnp.cos(ang)
            ly = r * jnp.sin(ang)
            lz = jnp.zeros(B, f)
        else:  # POS_CUBE
            lx = (2.0 * u[1] - 1.0) * pspec[1]
            ly = (2.0 * u[2] - 1.0) * pspec[2]
            lz = (2.0 * u[3] - 1.0) * pspec[3]
        # direction (local frame), trig-minimal
        dkind, dparam = dspec
        phi = 2.0 * np.pi * u[5]
        cphi = jnp.cos(phi)
        sphi = jnp.sin(phi)
        if dkind == C.DIR_DEFAULT:
            ldx = jnp.zeros(B, f)
            ldy = jnp.zeros(B, f)
            ldz = jnp.ones(B, f)
        else:
            if dkind == C.DIR_CONE:
                st = jnp.sqrt(u[4]) * np.sin(dparam)
                mu = jnp.sqrt(jnp.clip(1.0 - st * st, 0.0, None))
            elif dkind == C.DIR_ISOTROPIC:
                mu = 2.0 * u[4] - 1.0
                st = jnp.sqrt(jnp.clip(1.0 - mu * mu, 0.0, None))
            elif dkind == C.DIR_LAMBERTIAN:
                st = jnp.sqrt(u[4])
                mu = jnp.sqrt(jnp.clip(1.0 - u[4], 0.0, None))
            else:  # DIR_HG
                g = dparam
                if abs(g) < 1e-12:
                    mu = 2.0 * u[4] - 1.0
                else:
                    s = 2.0 * u[4] - 1.0
                    mu = (
                        1.0 + g * g - ((1.0 - g * g) / (1.0 + g * s)) ** 2
                    ) / (2.0 * g)
                    mu = jnp.clip(mu, -1.0, 1.0)
                st = jnp.sqrt(jnp.clip(1.0 - mu * mu, 0.0, None))
            ldx = st * cphi
            ldy = st * sphi
            ldz = mu
        # to world frame
        m = matrix
        wxp = m[0][0] * lx + m[0][1] * ly + m[0][2] * lz + m[0][3]
        wyp = m[1][0] * lx + m[1][1] * ly + m[1][2] * lz + m[1][3]
        wzp = m[2][0] * lx + m[2][1] * ly + m[2][2] * lz + m[2][3]
        wxd = m[0][0] * ldx + m[0][1] * ldy + m[0][2] * ldz
        wyd = m[1][0] * ldx + m[1][1] * ldy + m[1][2] * ldz
        wzd = m[2][0] * ldx + m[2][1] * ldy + m[2][2] * ldz
        if n_lights == 1:
            px, py, pz = wxp, wyp, wzp
            dxv, dyv, dzv = wxd, wyd, wzd
            wav = w_l
        else:
            px = jnp.where(here, wxp, px)
            py = jnp.where(here, wyp, py)
            pz = jnp.where(here, wzp, pz)
            dxv = jnp.where(here, wxd, dxv)
            dyv = jnp.where(here, wyd, dyv)
            dzv = jnp.where(here, wzd, dzv)
            wav = jnp.where(here, w_l, wav)
    return (px, py, pz), (dxv, dyv, dzv), wav


def _device_emit(compiled, cfg, tables, keys, photon_ids):
    """Stacked [B, 3] wrapper over `_device_emit_flat` for the XLA body."""
    (px, py, pz), (dxv, dyv, dzv), wav = _device_emit_flat(
        compiled, cfg, tables, keys, photon_ids
    )
    pos3 = jnp.stack([px, py, pz], axis=-1)
    dir3 = jnp.stack([dxv, dyv, dzv], axis=-1)
    return pos3, dir3, wav


def trace_bundle_device_emit(compiled, cfg: TraceConfig, tables, base_key,
                             n_rays, index_offset=0, lanes=None):
    """Emit on device then trace — zero host work per bundle.

    With ``lanes < n_rays`` the tracer runs in **regeneration** mode:
    the wavefront is `lanes` wide and every lane that dies is refilled
    with a freshly emitted photon until the `n_rays` budget is spent.
    Without regeneration a bundle costs (longest-lived photon) steps at
    full width while the mean lifetime is ~4x shorter — regeneration
    keeps the lanes ~100% alive, so throughput follows the *mean*
    lifetime instead of the max (the wavefront-compaction idea from GPU
    path tracing, done budget-side instead of sort-side). Each photon's
    entire stream is a pure function of ``fold_in(base_key, pid)``, so
    tallies are independent of lane scheduling.
    """
    if lanes is None or (
        isinstance(n_rays, int) and lanes >= n_rays
    ):
        photon_ids, keys = _photon_keys(base_key, n_rays, index_offset)
        pos3, dir3, wav = _device_emit(
            compiled, cfg, tables, keys, photon_ids
        )
        return _run(
            compiled, cfg, tables, photon_ids, keys, pos3, dir3, wav
        )
    # `n_rays` may be a traced scalar here: the budget only appears in
    # comparisons, so one compiled program serves any photon count.
    photon_ids, keys = _photon_keys(base_key, lanes, index_offset)
    pos3, dir3, wav = _device_emit(compiled, cfg, tables, keys, photon_ids)
    total = jnp.uint32(index_offset) + jnp.asarray(n_rays, jnp.uint32)
    return _run(
        compiled, cfg, tables, photon_ids, keys, pos3, dir3, wav,
        regen=(base_key, total),
    )


def trace_bundle(compiled, cfg: TraceConfig, tables, positions, directions,
                 wavelengths, base_key, index_offset=0):
    """Trace a host-emitted photon bundle to completion.

    `compiled` supplies static structure + host constants (baked into
    the program); `tables` supplies the packed spectral arrays; `cfg` is
    the static config. Returns (tallies, event_log, counts, steps).
    """
    B = positions.shape[0]
    photon_ids, keys = _photon_keys(base_key, B, index_offset)
    return _run(
        compiled, cfg, tables, photon_ids, keys,
        positions.astype(cfg.dtype), directions.astype(cfg.dtype),
        wavelengths.astype(cfg.dtype),
    )


def _run(compiled, cfg: TraceConfig, tables, photon_ids, keys, positions,
         directions, wavelengths, regen=None):
    N = cfg.n_nodes
    f = cfg.dtype
    B = positions.shape[0]
    eps = cfg.eps
    L = cfg.grid_n
    M = cfg.icdf_n

    # Host constants baked into the program
    W2L = np.asarray(compiled.world_to_local, dtype=f)
    L2W = np.asarray(compiled.local_to_world, dtype=f)
    GP = np.asarray(compiled.geom_params, dtype=np.float64)
    NIDX = [float(v) for v in compiled.refractive_index]
    node_static = compiled.node_static
    comp_static = compiled.comp_static
    n_comps = len(comp_static)
    has_spectra = any(ns[2] > 0 for ns in node_static)
    any_overrides = any(len(ns[5]) > 0 for ns in node_static)
    any_lambertian = any(
        o[0] == OVR_LAMBERTIAN for ns in node_static for o in ns[5]
    )
    fresnel_nodes = [
        n for n in range(N) if node_static[n][1] == comp.SURF_FRESNEL
    ]
    # comp -> (node K, lum ordinal) for emission CDF column lookup
    comp_node_info = {}
    for n in range(N):
        K = node_static[n][2]
        for cid, j in node_static[n][4]:
            comp_node_info[cid] = (K, j)

    pos0 = positions.astype(f)
    dir0 = directions.astype(f)
    px, py, pz = pos0[:, 0], pos0[:, 1], pos0[:, 2]
    dx_, dy_, dz_ = dir0[:, 0], dir0[:, 1], dir0[:, 2]
    wav0 = wavelengths.astype(f)

    if cfg.record_every > 0:
        # Slots are relative to the first recorded pid >= the bundle's
        # index offset, so streamed bundles (exact-union mode) record
        # the same global every-k-th photons a single big call would.
        re_u = jnp.uint32(cfg.record_every)
        first_rec = (photon_ids[0] + re_u - 1) // re_u * re_u
        slot = jnp.where(
            photon_ids % re_u == 0,
            ((photon_ids - first_rec) // re_u).astype(jnp.int32),
            cfg.n_slots,
        )
    else:
        first_rec = jnp.uint32(0)
        slot = jnp.full(B, cfg.n_slots, dtype=jnp.int32)

    log = _empty_log(cfg)
    nevents = jnp.zeros(B, dtype=jnp.int32)
    minus1 = jnp.full(B, -1, jnp.int32)
    log, nevents = _record(
        log, nevents, slot, jnp.ones(B, dtype=bool), cfg,
        kind=EV_GENERATE, hit=minus1, container=minus1, adjacent=minus1,
        component=minus1, source=minus1, pos3=pos0, dir3=dir0,
        normal3=None, wavelength=wav0, travelled=jnp.zeros(B, f),
        duration=jnp.zeros(B, f),
    )

    state = {
        "px": px, "py": py, "pz": pz,
        "dx": dx_, "dy": dy_, "dz": dz_,
        "wav": wav0,
        "trav": jnp.zeros(B, f),
        "dur": jnp.zeros(B, f),
        "source": jnp.full(B, -1, jnp.int32),
        "alive": jnp.ones(B, dtype=bool),
        "count": jnp.zeros(B, jnp.int32),
        "step": jnp.zeros((), jnp.int32),
        "k0": keys[0],
        "k1": keys[1],
        "nevents": nevents,
        "slot": slot,
        "log": log,
        "tallies": _empty_tallies(cfg, B),
    }
    if cfg.score:
        state["score"] = jnp.zeros(
            (cfg.n_comps + cfg.n_nodes + len(cfg.pathwise), B), f
        )
        if cfg.pathwise:
            # Per-channel pathwise tangents of the continuous photon
            # coordinates: [C_pw, 7, B] = d(px,py,pz,dx,dy,dz,wav)/d theta.
            state["tang"] = jnp.zeros((len(cfg.pathwise), 7, B), f)
    if regen is not None:
        regen_base_key, regen_total = regen
        state["pid"] = photon_ids
        state["next"] = photon_ids[-1].astype(jnp.uint32) + jnp.uint32(1)

    spec_pack = tables["spec_pack"]
    icdf_pairs = tables["ems_icdf_pairs"]

    def cond(state):
        return jnp.any(state["alive"])

    # ------------------------------------------------------------------
    # Shared physics core (fast path: no event log, no score).
    #
    # One step of every photon: draws -> next hit -> container -> EXIT /
    # absorb / re-emit / surface -> new state + per-lane event masks.
    # Interpolation is injected (`spec_slots_fn`, `icdf_fn`) so gather
    # tables and Chebyshev surrogates plug into the same body. Mirrors the full body below event-for-event; the body additionally
    # interleaves event-log records and score accumulation.

    maxK = max(ns[2] for ns in node_static) if has_spectra else 0
    comp_nodes = [n for n in range(N) if node_static[n][2] > 0]
    # Triangle tables baked as program constants (meshes here are small;
    # reference docs note trimesh is single-precision anyway)
    # Host copies; _mesh_nearest_two bakes them as scalar constants
    # (small meshes) or device constants (fori_loop path).
    mesh_consts = {
        n: tuple(np.asarray(a, dtype=f) for a in compiled.mesh_data[n])
        for n in compiled.mesh_data
    }

    def physics_core(u, px, py, pz, dxv, dyv, dzv, wav, trav, dur,
                     source, alive, count, spec_slots_fn, icdf_fn,
                     want_extras=False, nidx=None, gp=None):
        # Shape tuple, not a width: the core is shape-agnostic and
        # runs on [B] wavefronts of any rank.
        #
        # `nidx` / `gp` optionally replace the baked refractive indices
        # and geometry parameters with traced values — the pathwise
        # gradient path linearizes the whole step w.r.t. them (see the
        # score block in `body`); every other caller leaves them None
        # and gets the compile-time constants.
        if nidx is None:
            nidx = NIDX
        if gp is None:
            gp = [GP[n].astype(f) for n in range(N)]
        Bl = px.shape
        inf = jnp.full(Bl, _INF, f)
        t1 = inf
        n1 = jnp.zeros(Bl, jnp.int32)
        t2 = inf
        n2 = jnp.zeros(Bl, jnp.int32)
        nhits = jnp.zeros(Bl, jnp.int32)
        cont_t = inf
        cont_n = jnp.zeros(Bl, jnp.int32)
        local_frames = []
        mesh_normals = {}
        for n in range(N):
            R = W2L[n]
            lox = R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz + R[0, 3]
            loy = R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz + R[1, 3]
            loz = R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + R[2, 3]
            ldx = R[0, 0] * dxv + R[0, 1] * dyv + R[0, 2] * dzv
            ldy = R[1, 0] * dxv + R[1, 1] * dyv + R[1, 2] * dzv
            ldz = R[2, 0] * dxv + R[2, 1] * dyv + R[2, 2] * dzv
            local_frames.append((lox, loy, loz, ldx, ldy, ldz))
            if node_static[n][0] == comp.GEOM_MESH:
                mt1, mt2, cnt_n, mnx, mny, mnz = _mesh_nearest_two(
                    mesh_consts[n], (lox, loy, loz), (ldx, ldy, ldz),
                    eps[n],
                )
                mesh_normals[n] = (mnx, mny, mnz)
                tmin_n = mt1
                cands = [(mt1, cnt_n >= 1), (mt2, cnt_n >= 2)]
                for t, valid in cands:
                    tv = jnp.where(valid, t, _INF)
                    isfirst = tv < t1
                    issecond = ~isfirst & (tv < t2)
                    t2 = jnp.where(isfirst, t1, jnp.where(issecond, tv, t2))
                    n2 = jnp.where(isfirst, n1, jnp.where(issecond, n, n2))
                    t1 = jnp.where(isfirst, tv, t1)
                    n1 = jnp.where(isfirst, n, n1)
            else:
                cands = _intersect_node_static(
                    node_static[n][0], gp[n], (lox, loy, loz),
                    (ldx, ldy, ldz), eps[n],
                )
                cnt_n = jnp.zeros(Bl, jnp.int32)
                tmin_n = inf
                for t, valid in cands:
                    tv = jnp.where(valid, t, _INF)
                    cnt_n = cnt_n + valid.astype(jnp.int32)
                    tmin_n = jnp.minimum(tmin_n, tv)
                    isfirst = tv < t1
                    issecond = ~isfirst & (tv < t2)
                    t2 = jnp.where(isfirst, t1, jnp.where(issecond, tv, t2))
                    n2 = jnp.where(isfirst, n1, jnp.where(issecond, n, n2))
                    t1 = jnp.where(isfirst, tv, t1)
                    n1 = jnp.where(isfirst, n, n1)
            nhits = nhits + cnt_n
            is_cand = (cnt_n == 1) & (tmin_n < cont_t)
            cont_t = jnp.where(is_cand, tmin_n, cont_t)
            cont_n = jnp.where(is_cand, n, cont_n)

        no_hit = nhits == 0
        hit = n1
        t0 = t1
        container = jnp.where(jnp.isfinite(cont_t), cont_n, hit)
        adjacent = jnp.where(container == hit, n2, hit)
        container = jnp.where(nhits == 1, hit, container)
        adjacent = jnp.where(nhits == 1, -1, adjacent)

        no_hit_term = alive & no_hit
        alive = alive & ~no_hit

        # KILL on step cap or pathlength cap, checked at the top of the
        # event loop exactly like the oracle (photon_tracer.step_forward)
        kill_max = alive & (count > cfg.maxsteps)
        if np.isfinite(cfg.maxpathlength):
            kill_max = kill_max | (alive & (trav > cfg.maxpathlength))
        alive = alive & ~kill_max

        n_cont = _select(container, nidx, jnp.full(Bl, 1.0, f))
        exit_mask = alive & (hit == cfg.root_id)

        if has_spectra:
            posf = (wav - cfg.grid_x0) / cfg.grid_dx
            i0 = jnp.clip(posf.astype(jnp.int32), 0, L - 2)
            frac = jnp.clip(posf - i0.astype(f), 0.0, 1.0)
            slot_vals = spec_slots_fn(container, i0, frac)
            cums = slot_vals
            alpha = _select(
                container,
                [
                    cums[ns[2] - 1] if ns[2] > 0 else jnp.zeros(Bl, f)
                    for ns in node_static
                ],
                jnp.zeros(Bl, f),
            )
        else:
            alpha = jnp.zeros(Bl, f)

        depth = jnp.where(
            alpha > ALPHA_ZERO,
            -jnp.log1p(-u[0]) / jnp.maximum(alpha, 1e-30),
            _INF,
        )
        absorbed = alive & ~exit_mask & (depth < t0)

        advance = jnp.where(absorbed, depth, t0)
        px = jnp.where(alive, px + dxv * advance, px)
        py = jnp.where(alive, py + dyv * advance, py)
        pz = jnp.where(alive, pz + dzv * advance, pz)
        trav = jnp.where(alive, trav + advance, trav)
        dur = jnp.where(alive, dur + advance * n_cont / C_CM_PER_S, dur)
        # Snapshots for event-log records / score accumulation
        dur_adv = dur
        moving = alive
        source_pre = source

        if has_spectra:
            target = u[1] * alpha
            comp_vals = []
            for ns in node_static:
                K, comp_ids = ns[2], ns[3]
                if K == 0:
                    comp_vals.append(jnp.full(Bl, -1, jnp.int32))
                    continue
                ordinal = jnp.zeros(Bl, jnp.int32)
                for k in range(K - 1):
                    ordinal = ordinal + (cums[k] < target).astype(jnp.int32)
                cid = jnp.full(Bl, comp_ids[K - 1], jnp.int32)
                for k in range(K - 1):
                    cid = jnp.where(ordinal == k, comp_ids[k], cid)
                comp_vals.append(cid)
            comp_id = _select(
                container, comp_vals, jnp.full(Bl, -1, jnp.int32)
            )

            def comp_attr(values, init):
                acc = jnp.full(Bl, init, f)
                for c in range(n_comps):
                    acc = jnp.where(comp_id == c, values[c], acc)
                return acc

            qy = comp_attr([cs[1] for cs in comp_static], 0.0)
            radiative_comps = [
                c for c in range(n_comps)
                if comp_static[c][0] in (comp.COMP_SCATTERER,
                                         comp.COMP_LUMINOPHORE)
            ]
            can_radiate = _member(comp_id, radiative_comps)
            radiative = absorbed & can_radiate & (u[2] < qy)

            phase_groups = {}
            for c in radiative_comps:
                keyg = (comp_static[c][4], comp_static[c][5])
                phase_groups.setdefault(keyg, []).append(c)
            ndx = jnp.zeros(Bl, f)
            ndy = jnp.zeros(Bl, f)
            ndz = jnp.ones(Bl, f)
            phi = 2.0 * np.pi * u[4]
            cphi = jnp.cos(phi)
            sphi = jnp.sin(phi)
            for (ptype, pparam), members in phase_groups.items():
                if ptype == comp.PHASE_HENYEY_GREENSTEIN and abs(pparam) >= 1e-12:
                    g = pparam
                    s = 2.0 * u[3] - 1.0
                    mu = (
                        1.0 + g * g - ((1.0 - g * g) / (1.0 + g * s)) ** 2
                    ) / (2.0 * g)
                    mu = jnp.clip(mu, -1.0, 1.0)
                elif ptype == comp.PHASE_CONE:
                    st = jnp.sqrt(u[3]) * np.sin(pparam)
                    mu = jnp.sqrt(jnp.clip(1.0 - st * st, 0.0, None))
                else:
                    mu = 2.0 * u[3] - 1.0
                st = jnp.sqrt(jnp.clip(1.0 - mu * mu, 0.0, None))
                in_group = _member(comp_id, members)
                ndx = jnp.where(in_group, st * cphi, ndx)
                ndy = jnp.where(in_group, st * sphi, ndy)
                ndz = jnp.where(in_group, mu, ndz)

            lum_comps = [
                c for c in range(n_comps)
                if comp_static[c][0] == comp.COMP_LUMINOPHORE
            ]
            is_lum = _member(comp_id, lum_comps)
            emitting = radiative & is_lum

            if cfg.n_lum > 0:
                if cfg.emit_method == comp.EMIT_FULL:
                    p1 = jnp.zeros(Bl, f)
                else:
                    p1 = jnp.zeros(Bl, f)
                    for c in lum_comps:
                        K_n, j = comp_node_info[c]
                        w = K_n + 2 * j + (
                            0 if cfg.emit_method == comp.EMIT_KT else 1
                        )
                        p1 = jnp.where(comp_id == c, slot_vals[w], p1)
                gamma = p1 + (1.0 - p1) * u[5]
                lumidx = comp_attr(
                    [max(cs[6], 0) for cs in comp_static], 0.0
                ).astype(jnp.int32)
                new_wav = icdf_fn(lumidx, gamma)
                tau_rad = comp_attr([cs[2] for cs in comp_static], 0.0)
                rad_delay = jnp.where(
                    tau_rad > 0.0, -jnp.log1p(-u[6]) * tau_rad, 0.0
                )
                wav = jnp.where(emitting, new_wav, wav)
                dur = jnp.where(emitting, dur + rad_delay, dur)

            dxv = jnp.where(radiative, ndx, dxv)
            dyv = jnp.where(radiative, ndy, dyv)
            dzv = jnp.where(radiative, ndz, dzv)
            source = jnp.where(radiative, comp_id, source)

            nonrad = absorbed & ~radiative
            tau_nr = comp_attr([cs[3] for cs in comp_static], 0.0)
            nr_delay = jnp.where(
                tau_nr > 0.0, -jnp.log1p(-u[6]) * tau_nr, 0.0
            )
            dur = jnp.where(nonrad, dur + nr_delay, dur)
            reactor_comps = [
                c for c in range(n_comps)
                if comp_static[c][0] == comp.COMP_REACTOR
            ]
            reacting = nonrad & _member(comp_id, reactor_comps)
            losing = nonrad & ~reacting
            scattering = radiative & ~is_lum
        else:
            comp_id = jnp.full(Bl, -1, jnp.int32)
            nonrad = jnp.zeros(Bl, dtype=bool)
            reacting = losing = nonrad
            radiative = emitting = scattering = nonrad
            slot_vals = []

        # --- surface interaction --------------------------------------
        surf = alive & ~exit_mask & ~absorbed
        adj_bad = surf & (adjacent < 0)
        surf = surf & ~adj_bad

        lnx = jnp.zeros(Bl, f)
        lny = jnp.zeros(Bl, f)
        lnz = jnp.ones(Bl, f)
        wnx = jnp.zeros(Bl, f)
        wny = jnp.zeros(Bl, f)
        wnz = jnp.ones(Bl, f)
        ovr_mode = None
        for n in range(N):
            lox, loy, loz, ldx, ldy, ldz = local_frames[n]
            if node_static[n][0] == comp.GEOM_MESH:
                # Normal of the node's first forward hit, captured
                # during intersection (valid exactly when hit == n,
                # i.e. when this node's first hit is the global first).
                nx_n, ny_n, nz_n = mesh_normals[n]
            else:
                lpx = lox + t0 * ldx
                lpy = loy + t0 * ldy
                lpz = loz + t0 * ldz
                nx_n, ny_n, nz_n = _local_normal_static(
                    node_static[n][0], gp[n], (lpx, lpy, lpz)
                )
            Rw = L2W[n]
            wx = Rw[0, 0] * nx_n + Rw[0, 1] * ny_n + Rw[0, 2] * nz_n
            wy = Rw[1, 0] * nx_n + Rw[1, 1] * ny_n + Rw[1, 2] * nz_n
            wz = Rw[2, 0] * nx_n + Rw[2, 1] * ny_n + Rw[2, 2] * nz_n
            here = hit == n
            lnx = jnp.where(here, nx_n, lnx)
            lny = jnp.where(here, ny_n, lny)
            lnz = jnp.where(here, nz_n, lnz)
            wnx = jnp.where(here, wx, wnx)
            wny = jnp.where(here, wy, wny)
            wnz = jnp.where(here, wz, wnz)
            if node_static[n][5]:
                mode_n = jnp.full(Bl, comp.OVR_NONE, jnp.int32)
                for (mode, (ox0, oy0, oz0), atol) in node_static[n][5]:
                    matchf = (
                        (jnp.abs(nx_n - ox0) <= atol)
                        & (jnp.abs(ny_n - oy0) <= atol)
                        & (jnp.abs(nz_n - oz0) <= atol)
                    )
                    mode_n = jnp.where((mode_n < 0) & matchf, mode, mode_n)
                if ovr_mode is None:
                    ovr_mode = jnp.full(Bl, comp.OVR_NONE, jnp.int32)
                ovr_mode = jnp.where(here, mode_n, ovr_mode)
        if ovr_mode is None:
            ovr_mode = jnp.full(Bl, comp.OVR_NONE, jnp.int32)

        ddot = wnx * dxv + wny * dyv + wnz * dzv
        c_in = jnp.clip(jnp.abs(ddot), 0.0, 1.0)
        flip = jnp.where(ddot < 0.0, -1.0, 1.0)
        nax = wnx * flip
        nay = wny * flip
        naz = wnz * flip

        n1r = n_cont
        n2r = _select(adjacent, nidx, jnp.full(Bl, 1.0, f))
        is_fresnel = _member(hit, fresnel_nodes)

        s2 = jnp.clip(1.0 - c_in * c_in, 0.0, 1.0)
        ratio = n1r / n2r
        tir = (n2r < n1r) & (s2 * ratio * ratio > 1.0)
        under = jnp.clip(1.0 - ratio * ratio * s2, 0.0, None)
        kterm = jnp.sqrt(under)
        rs = ((n1r * c_in - n2r * kterm) / (n1r * c_in + n2r * kterm)) ** 2
        rp = ((n1r * kterm - n2r * c_in) / (n1r * kterm + n2r * c_in)) ** 2
        r = jnp.where(tir, 1.0, jnp.clip(0.5 * (rs + rp), 0.0, 1.0))
        r = jnp.where(is_fresnel, r, 0.0)
        if any_overrides:
            r = jnp.where(
                (ovr_mode == OVR_MIRROR) | (ovr_mode == OVR_LAMBERTIAN),
                1.0, r,
            )
            r = jnp.where(ovr_mode == OVR_ABSORB, 0.0, r)

        reflecting = surf & (u[7] < r)
        transmitting = surf & ~reflecting

        two_d = 2.0 * c_in
        rfx = dxv - two_d * nax
        rfy = dyv - two_d * nay
        rfz = dzv - two_d * naz
        if any_lambertian:
            st_l = jnp.sqrt(u[3])
            ct_l = jnp.sqrt(jnp.clip(1.0 - u[3], 0.0, None))
            phi_l = 2.0 * np.pi * u[4]
            lx = st_l * jnp.cos(phi_l)
            ly = st_l * jnp.sin(phi_l)
            axx, axy, axz = -nax, -nay, -naz
            sign = jnp.where(axz >= 0.0, 1.0, -1.0)
            a_ = -1.0 / (sign + axz)
            b_ = axx * axy * a_
            t1x = 1.0 + sign * axx * axx * a_
            t1y = sign * b_
            t1z = -sign * axx
            t2x = b_
            t2y = sign + axy * axy * a_
            t2z = -axy
            lamx = lx * t1x + ly * t2x + ct_l * axx
            lamy = lx * t1y + ly * t2y + ct_l * axy
            lamz = lx * t1z + ly * t2z + ct_l * axz
            lam_mask = ovr_mode == OVR_LAMBERTIAN
            rfx = jnp.where(lam_mask, lamx, rfx)
            rfy = jnp.where(lam_mask, lamy, rfy)
            rfz = jnp.where(lam_mask, lamz, rfz)

        cterm = jnp.sqrt(
            jnp.clip(1.0 - ratio * ratio * (1.0 - c_in * c_in), 0.0, None)
        )
        scale = cterm - ratio * c_in
        txd = ratio * dxv + scale * nax
        tyd = ratio * dyv + scale * nay
        tzd = ratio * dzv + scale * naz
        pass_through = ~is_fresnel
        if any_overrides:
            pass_through = pass_through | (ovr_mode == OVR_ABSORB)
        txd = jnp.where(pass_through, dxv, txd)
        tyd = jnp.where(pass_through, dyv, tyd)
        tzd = jnp.where(pass_through, dzv, tzd)

        dxv = jnp.where(reflecting, rfx, jnp.where(transmitting, txd, dxv))
        dyv = jnp.where(reflecting, rfy, jnp.where(transmitting, tyd, dyv))
        dzv = jnp.where(reflecting, rfz, jnp.where(transmitting, tzd, dzv))

        # Recorder selectors (same mapping as the tally section below)
        sel = jnp.full(Bl, SEL_NONE, jnp.int32)
        tnode = jnp.full(Bl, -1, jnp.int32)
        have_n = jnp.zeros(Bl, dtype=bool)
        if cfg.n_recorders > 0:
            sel = jnp.where(kill_max, REC_KILLED, sel)
            tnode = jnp.where(kill_max, container, tnode)
            sel = jnp.where(exit_mask, REC_EXIT, sel)
            tnode = jnp.where(exit_mask, hit, tnode)
            have_n = have_n | exit_mask
            sel = jnp.where(reacting, REC_REACTED, sel)
            sel = jnp.where(losing, REC_LOST, sel)
            tnode = jnp.where(reacting | losing, container, tnode)
            refl_tally = reflecting & (container != hit)
            sel = jnp.where(refl_tally, REC_REFLECTED, sel)
            tnode = jnp.where(refl_tally, hit, tnode)
            have_n = have_n | refl_tally
            sel = jnp.where(
                transmitting,
                jnp.where(container == hit, REC_ESCAPING, REC_ENTERING),
                sel,
            )
            tnode = jnp.where(transmitting, hit, tnode)
            have_n = have_n | transmitting

        alive = alive & ~exit_mask & ~nonrad
        out = {
            "px": px, "py": py, "pz": pz,
            "dx": dxv, "dy": dyv, "dz": dzv,
            "wav": wav, "trav": trav, "dur": dur,
            "source": source, "alive": alive, "count": count,
            "exit_mask": exit_mask, "losing": losing,
            "reacting": reacting, "kills": kill_max | adj_bad,
            "no_hit_term": no_hit_term,
            "sel": sel, "tnode": tnode, "have_n": have_n,
            "wnx": wnx, "wny": wny, "wnz": wnz, "c_in": c_in,
            "surface_event": exit_mask | reflecting | transmitting,
        }
        if want_extras:
            # Everything the event-log records and the score estimator
            # need, snapshotted at the semantically correct points.
            fres_coin = is_fresnel & ~tir
            if any_overrides:
                fres_coin = fres_coin & (ovr_mode == comp.OVR_NONE)
            out.update(
                hit=hit, container=container, adjacent=adjacent,
                comp_id=comp_id, absorbed=absorbed, radiative=radiative,
                emitting=emitting, scattering=scattering,
                kill_max=kill_max, adj_bad=adj_bad,
                reflecting=reflecting, transmitting=transmitting,
                moving=moving, advance=advance, alpha=alpha, t0=t0,
                dur_adv=dur_adv, source_pre=source_pre,
                slot_vals=slot_vals,
                n1r=n1r, n2r=n2r, refl_r=r, fres_coin=fres_coin,
            )
        return out

    # -- interpolation callbacks ----------------------------------------

    # Gather path: one wide [Bl, 2W] row gather + per-column slices
    # (rather than one 1-D gather per slot).

    def spec_slots_gather(container, i0, frac):
        row = jnp.clip(container, 0, N - 1) * L + i0
        packed = spec_pack[row]  # [Bl, 2W] — the one wide gather
        return [
            packed[:, 2 * w]
            + frac * (packed[:, 2 * w + 1] - packed[:, 2 * w])
            for w in range(compiled.pack_width)
        ]

    def icdf_gather(lumidx, gamma):
        gposf = gamma * (M - 1)
        j0 = jnp.clip(gposf.astype(jnp.int32), 0, M - 2)
        gfrac = gposf - j0.astype(f)
        prow = icdf_pairs[lumidx * M + j0]  # [Bl, 2]
        return prow[:, 0] + gfrac * (prow[:, 1] - prow[:, 0])

    # Chebyshev surrogates (compiler-fitted, gather-free), chosen over
    # the row gather on the engine's first accelerator; ROADMAP Speed 5
    # measures both on the GPU. Enabled whenever the
    # compiler's fits met tolerance; PVTRACE_TPU_NO_CHEB forces the
    # exact table-gather path (note the tracer cache keys on the scene
    # digest + config, so flip it before the first trace of a scene).
    no_cheb = bool(os.environ.get("PVTRACE_TPU_NO_CHEB", ""))
    cheb_spec = getattr(compiled, "cheb_spec", None)
    cheb_comp = getattr(compiled, "cheb_comp", None)
    cheb_icdf = getattr(compiled, "cheb_icdf", None)

    def spec_slots_cheb(container, i0, frac):
        t = (i0.astype(f) + frac) * (2.0 / (L - 1)) - 1.0
        # Each component coefficient is evaluated once per step and
        # shared by every cumulative slot that references it.
        comp_cache = {}

        def comp_val(cid):
            if cid not in comp_cache:
                comp_cache[cid] = _eval_fit(t, cheb_comp[cid])
            return comp_cache[cid]

        out = []
        for w in range(compiled.pack_width):
            acc = jnp.zeros_like(t)
            for n in comp_nodes:
                fits = cheb_spec.get(n)
                if fits is None or w >= len(fits):
                    continue
                fit = fits[w]
                if fit[0] == "cum":
                    val = comp_val(fit[1][0])
                    for cid in fit[1][1:]:
                        val = val + comp_val(cid)
                else:
                    val = _eval_fit(t, fit)
                if len(comp_nodes) == 1:
                    acc = val  # other containers never read this slot
                else:
                    acc = jnp.where(container == n, val, acc)
            out.append(acc)
        return out

    def icdf_cheb(lumidx, gamma):
        tg = 2.0 * gamma - 1.0
        vals = [_eval_fit(tg, c) for c in cheb_icdf]
        return _select(lumidx, vals, jnp.zeros_like(gamma))

    spec_slots_fn = (
        spec_slots_cheb if (cheb_spec is not None and not no_cheb)
        else spec_slots_gather
    )
    icdf_fn = (
        icdf_cheb if (cheb_icdf is not None and cheb_icdf != [] and not no_cheb)
        else icdf_gather
    )

    def body_fast(state, step_fn):
        """Fast-path body: physics via `step_fn`, then shared tallies +
        regeneration. Requires cfg.n_slots == 0 and not cfg.score."""
        tallies = state["tallies"]
        step = state["step"] + 1
        result = step_fn(state)

        fates = tallies["fates"]
        for mask, fid in (
            (result["exit_mask"], EV_EXIT),
            (result["losing"], EV_NONRADIATIVE),
            (result["reacting"], EV_REACT),
            (result["kills"], EV_KILL),
        ):
            fates = fates.at[fid].add(jnp.sum(mask, dtype=jnp.int32))
        fates = fates.at[FATE_NO_HIT].add(
            jnp.sum(result["no_hit_term"], dtype=jnp.int32)
        )

        px, py, pz = result["px"], result["py"], result["pz"]
        wav, trav, dur = result["wav"], result["trav"], result["dur"]
        alive = result["alive"]

        if cfg.n_recorders > 0:
            sel = result["sel"]
            tnode = result["tnode"]
            angle = jnp.where(
                result["surface_event"], jnp.arccos(result["c_in"]), 0.0
            )
            tlx = jnp.zeros(B, f)
            tly = jnp.zeros(B, f)
            tlz = jnp.zeros(B, f)
            for n in range(N):
                R = W2L[n]
                here = tnode == n
                tlx = jnp.where(
                    here,
                    R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz + R[0, 3],
                    tlx,
                )
                tly = jnp.where(
                    here,
                    R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz + R[1, 3],
                    tly,
                )
                tlz = jnp.where(
                    here,
                    R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + R[2, 3],
                    tlz,
                )
            new_tallies = _tally(
                tallies, compiled, cfg, sel, tnode, result["have_n"],
                (result["wnx"], result["wny"], result["wnz"]),
                (tlx, tly, tlz), angle, wav, trav, dur,
            )
            new_tallies["fates"] = fates
            tallies = new_tallies
        else:
            tallies = dict(tallies)
            tallies["fates"] = fates

        out = {
            "px": px, "py": py, "pz": pz,
            "dx": result["dx"], "dy": result["dy"], "dz": result["dz"],
            "wav": wav, "trav": trav, "dur": dur,
            "source": result["source"],
            "alive": alive,
            "count": result["count"],
            "step": step,
            "k0": state["k0"],
            "k1": state["k1"],
            "nevents": state["nevents"],
            "slot": state["slot"],
            "log": state["log"],
            "tallies": tallies,
        }

        if regen is not None:
            pid = state["pid"]
            nxt = state["next"]
            dead = ~alive
            ranks = jnp.cumsum(dead.astype(jnp.uint32)) - jnp.uint32(1)
            cand = nxt + ranks
            refill = dead & (cand < jnp.asarray(regen_total, jnp.uint32))
            pid = jnp.where(refill, cand, pid)
            nxt = nxt + jnp.sum(refill, dtype=jnp.uint32)
            s0, s1 = _key_words(regen_base_key)
            nk0, nk1 = _threefry2x32(s0, s1, pid, jnp.zeros_like(pid))
            epos3, edir3, ewav = _device_emit(
                compiled, cfg, tables, (nk0, nk1), pid
            )
            zero = jnp.zeros(B, f)
            out["px"] = jnp.where(refill, epos3[:, 0], px)
            out["py"] = jnp.where(refill, epos3[:, 1], py)
            out["pz"] = jnp.where(refill, epos3[:, 2], pz)
            out["dx"] = jnp.where(refill, edir3[:, 0], result["dx"])
            out["dy"] = jnp.where(refill, edir3[:, 1], result["dy"])
            out["dz"] = jnp.where(refill, edir3[:, 2], result["dz"])
            out["wav"] = jnp.where(refill, ewav, wav)
            out["trav"] = jnp.where(refill, zero, trav)
            out["dur"] = jnp.where(refill, zero, dur)
            out["source"] = jnp.where(refill, -1, result["source"])
            out["count"] = jnp.where(refill, 0, result["count"])
            out["alive"] = alive | refill
            out["k0"] = nk0
            out["k1"] = nk1
            out["pid"] = pid
            out["next"] = nxt
            tallies = dict(tallies)
            tallies["seen"] = jnp.where(
                refill[:, None], False, tallies["seen"]
            )
            out["tallies"] = tallies

        return out

    def body(state):
        """Full-featured body: physics via `physics_core`, plus event-log
        records and score accumulation interleaved at the semantically
        correct points (snapshots come back as core extras). Used for
        validation runs (record_every > 0) and gradient runs
        (score=True); the tallies-only fast path is `body_fast`."""
        log = state["log"]
        nevents = state["nevents"]
        slot = state["slot"]
        tallies = state["tallies"]
        fates = tallies["fates"]
        score = state["score"] if cfg.score else None

        step = state["step"] + 1
        alive0 = state["alive"]
        count = state["count"] + alive0.astype(jnp.int32)
        pk0 = state["k0"]
        pk1 = state["k1"]
        u = _draw8(pk0, pk1, count.astype(jnp.uint32), f)

        in_pos3 = jnp.stack([state["px"], state["py"], state["pz"]], axis=-1)
        in_dir3 = jnp.stack([state["dx"], state["dy"], state["dz"]], axis=-1)

        # --- event-budget kill (recorded rays only) -------------------
        if cfg.n_slots > 0:
            recorded = slot < cfg.n_slots
            budget_kill = alive0 & recorded & (nevents >= cfg.max_events - 1)
            log, nevents = _record(
                log, nevents, slot, budget_kill, cfg,
                kind=EV_KILL, hit=-1, container=-1, adjacent=-1,
                component=-1, source=state["source"], pos3=in_pos3,
                dir3=in_dir3, normal3=None, wavelength=state["wav"],
                travelled=state["trav"], duration=state["dur"],
            )
            fates = fates.at[EV_KILL].add(
                jnp.sum(budget_kill, dtype=jnp.int32)
            )
            alive1 = alive0 & ~budget_kill
        else:
            budget_kill = jnp.zeros(B, dtype=bool)
            alive1 = alive0

        if cfg.pathwise:
            # Pathwise-hybrid gradient mode: linearize the WHOLE physics
            # step w.r.t. the requested parameters and the continuous
            # photon coordinates. One linearization gives the primal
            # step plus a linear map applied once per channel below.
            pw_specs = cfg.pathwise

            def core_t(theta, cpx, cpy, cpz, cdx, cdy, cdz, cwav):
                nidx_l = list(NIDX)
                gp_l = [GP[n].astype(f) for n in range(N)]
                for ci, spec in enumerate(pw_specs):
                    if spec[0] == "n":
                        k = int(spec[1])
                        nidx_l[k] = nidx_l[k] + theta[ci]
                    else:
                        k, pidx = int(spec[1]), int(spec[2])
                        row = [gp_l[k][j] for j in range(gp_l[k].shape[0])]
                        row[pidx] = row[pidx] + theta[ci]
                        gp_l[k] = row
                return physics_core(
                    u, cpx, cpy, cpz, cdx, cdy, cdz, cwav,
                    state["trav"], state["dur"], state["source"], alive1,
                    count, spec_slots_fn, icdf_fn, want_extras=True,
                    nidx=nidx_l, gp=gp_l,
                )

            theta0 = jnp.zeros((len(pw_specs),), f)
            r, step_lin = jax.linearize(
                core_t, theta0, state["px"], state["py"], state["pz"],
                state["dx"], state["dy"], state["dz"], state["wav"],
            )
        else:
            r = physics_core(
                u, state["px"], state["py"], state["pz"],
                state["dx"], state["dy"], state["dz"],
                state["wav"], state["trav"], state["dur"],
                state["source"], alive1, count,
                spec_slots_fn, icdf_fn, want_extras=True,
            )
        pos3 = jnp.stack([r["px"], r["py"], r["pz"]], axis=-1)
        dir3 = jnp.stack([r["dx"], r["dy"], r["dz"]], axis=-1)
        wn3 = jnp.stack([r["wnx"], r["wny"], r["wnz"]], axis=-1)

        for mask, fid in (
            (r["no_hit_term"], FATE_NO_HIT),
            (r["kill_max"], EV_KILL),
            (r["exit_mask"], EV_EXIT),
            (r["reacting"], EV_REACT),
            (r["losing"], EV_NONRADIATIVE),
            (r["adj_bad"], EV_KILL),
        ):
            fates = fates.at[fid].add(jnp.sum(mask, dtype=jnp.int32))

        # --- event-log records (same order/values as the kernel) ------
        log, nevents = _record(
            log, nevents, slot, r["kill_max"], cfg,
            kind=EV_KILL, hit=-1, container=r["container"], adjacent=-1,
            component=-1, source=state["source"], pos3=pos3, dir3=in_dir3,
            normal3=None, wavelength=r["wav"], travelled=r["trav"],
            duration=r["dur"],
        )
        log, nevents = _record(
            log, nevents, slot, r["exit_mask"], cfg,
            kind=EV_EXIT, hit=r["hit"], container=r["container"],
            adjacent=r["adjacent"], component=-1, source=r["source"],
            pos3=pos3, dir3=in_dir3, normal3=None, wavelength=r["wav"],
            travelled=r["trav"], duration=r["dur_adv"],
        )
        log, nevents = _record(
            log, nevents, slot, r["absorbed"], cfg,
            kind=EV_ABSORB, hit=-1, container=r["container"], adjacent=-1,
            component=r["comp_id"], source=r["source_pre"], pos3=pos3,
            dir3=in_dir3, normal3=None, wavelength=state["wav"],
            travelled=r["trav"], duration=r["dur_adv"],
        )
        log, nevents = _record(
            log, nevents, slot, r["emitting"], cfg,
            kind=EV_EMIT, hit=-1, container=r["container"], adjacent=-1,
            component=r["comp_id"], source=r["source"], pos3=pos3,
            dir3=dir3, normal3=None, wavelength=r["wav"],
            travelled=r["trav"], duration=r["dur"],
        )
        log, nevents = _record(
            log, nevents, slot, r["scattering"], cfg,
            kind=EV_SCATTER, hit=-1, container=r["container"], adjacent=-1,
            component=r["comp_id"], source=r["source"], pos3=pos3,
            dir3=dir3, normal3=None, wavelength=r["wav"],
            travelled=r["trav"], duration=r["dur"],
        )
        log, nevents = _record(
            log, nevents, slot, r["reacting"], cfg,
            kind=EV_REACT, hit=-1, container=r["container"], adjacent=-1,
            component=r["comp_id"], source=r["source"], pos3=pos3,
            dir3=dir3, normal3=None, wavelength=r["wav"],
            travelled=r["trav"], duration=r["dur"],
        )
        log, nevents = _record(
            log, nevents, slot, r["losing"], cfg,
            kind=EV_NONRADIATIVE, hit=-1, container=r["container"],
            adjacent=-1, component=r["comp_id"], source=r["source"],
            pos3=pos3, dir3=dir3, normal3=None, wavelength=r["wav"],
            travelled=r["trav"], duration=r["dur"],
        )
        log, nevents = _record(
            log, nevents, slot, r["adj_bad"], cfg,
            kind=EV_KILL, hit=r["hit"], container=r["container"],
            adjacent=-1, component=-1, source=r["source"], pos3=pos3,
            dir3=dir3, normal3=None, wavelength=r["wav"],
            travelled=r["trav"], duration=r["dur"],
        )
        log, nevents = _record(
            log, nevents, slot, r["reflecting"], cfg,
            kind=EV_REFLECT, hit=r["hit"], container=r["container"],
            adjacent=r["adjacent"], component=-1, source=r["source"],
            pos3=pos3, dir3=dir3, normal3=wn3, wavelength=r["wav"],
            travelled=r["trav"], duration=r["dur"],
        )
        log, nevents = _record(
            log, nevents, slot, r["transmitting"], cfg,
            kind=EV_TRANSMIT, hit=r["hit"], container=r["container"],
            adjacent=r["adjacent"], component=-1, source=r["source"],
            pos3=pos3, dir3=dir3, normal3=wn3, wavelength=r["wav"],
            travelled=r["trav"], duration=r["dur"],
        )

        # --- score accumulation ----------------------------------------
        if cfg.score:
            contribs = []
            if has_spectra:
                cums = r["slot_vals"]
                for c in range(n_comps):
                    terms = []
                    for n in range(N):
                        comp_ids_n = node_static[n][3]
                        if c not in comp_ids_n:
                            continue
                        k_own = comp_ids_n.index(c)
                        a_c = cums[k_own] - (
                            cums[k_own - 1] if k_own > 0 else 0.0
                        )
                        terms.append((n, a_c))
                    a_here = jnp.zeros(B, f)
                    for n, a_c in terms:
                        a_here = jnp.where(r["container"] == n, a_c, a_here)
                    ds = jnp.where(r["moving"], -a_here * r["advance"], 0.0)
                    ds = ds + (r["absorbed"] & (r["comp_id"] == c)).astype(f)
                    contribs.append(ds)
            else:
                contribs.extend(jnp.zeros(B, f) for _ in range(n_comps))
            # Refractive-index channels (one per node): each Fresnel
            # coin flip contributes d log P / d n_k, with P = R on the
            # reflected branch and 1 - R on the transmitted branch; n1
            # is the container's index and n2 the adjacent's, so one
            # interaction feeds up to two node channels. TIR and
            # facet-override interactions have P = 1 fixed (zero
            # score). NOTE: the deterministic Snell bending of the
            # transmitted direction is NOT differentiated — the
            # estimator captures the probability dependence only, which
            # is exact when transmitted geometry is n-independent
            # (normal incidence) and a partial derivative otherwise.
            dR1, dR2 = _fresnel_dR(r["n1r"], r["n2r"], r["c_in"])
            rr = r["refl_r"]
            coin = r["fres_coin"] & (r["reflecting"] | r["transmitting"])
            ratio_r = 1.0 / jnp.maximum(rr, 1e-12)
            ratio_t = -1.0 / jnp.maximum(1.0 - rr, 1e-12)
            branch = jnp.where(r["reflecting"], ratio_r, ratio_t)
            w1 = jnp.where(coin, jnp.nan_to_num(dR1 * branch), 0.0)
            w2 = jnp.where(coin, jnp.nan_to_num(dR2 * branch), 0.0)
            for k in range(N):
                ck = jnp.where(r["container"] == k, w1, 0.0)
                ck = ck + jnp.where(r["adjacent"] == k, w2, 0.0)
                contribs.append(ck)
            if cfg.pathwise:
                # Hybrid pathwise channels. Per step each channel adds
                #   * the free-flight survival likelihood  -d(alpha*t0)
                #     on lanes that reached a boundary,
                #   * the collision-branch likelihood
                #     d log(1 - e^{-alpha t0}) on absorbed lanes (the
                #     slab geometric-series expansion shows survival
                #     alone is incomplete — docs/GRADIENTS.md), with the
                #     absorption point moved under the truncated-density
                #     reparameterization, and
                #   * the Fresnel coin likelihood with the FULL dR
                #     (explicit n-dependence plus incidence-cosine
                #     movement), so the Snell bending of earlier
                #     transmissions feeds later coins and chords through
                #     the propagated tangents.
                tang = state["tang"]
                new_tang = []
                surv = r["moving"] & ~r["absorbed"]
                finite_t0 = jnp.isfinite(r["t0"])
                t0_fin = jnp.where(finite_t0, r["t0"], 0.0)
                a_t0 = r["alpha"] * t0_fin
                # Collision-branch probability 1 - e^{-alpha t0} and the
                # truncated-density reparameterization factor for the
                # sampled depth s: ds/dt0 = e^{alpha(s-t0)} F(s)/F(t0).
                coll_denom = jnp.maximum(-jnp.expm1(-a_t0), 1e-12)
                coll = r["absorbed"] & finite_t0
                s_dep = r["advance"]  # = sampled depth on absorbed lanes
                rep_fac = (
                    jnp.exp(jnp.minimum(r["alpha"] * (s_dep - t0_fin), 0.0))
                    * (-jnp.expm1(-r["alpha"] * s_dep)) / coll_denom
                )
                for ci in range(len(cfg.pathwise)):
                    th_dot = jnp.zeros((len(cfg.pathwise),), f)
                    th_dot = th_dot.at[ci].set(1.0)
                    d = step_lin(
                        th_dot, tang[ci, 0], tang[ci, 1], tang[ci, 2],
                        tang[ci, 3], tang[ci, 4], tang[ci, 5], tang[ci, 6],
                    )
                    dt0 = jnp.nan_to_num(d["t0"])
                    dalpha = jnp.nan_to_num(d["alpha"])
                    d_at0 = dalpha * t0_fin + r["alpha"] * dt0
                    # survive-to-boundary: d log e^{-alpha t0}
                    ds = jnp.where(surv, -d_at0, 0.0)
                    # collide-before-boundary: d log (1 - e^{-alpha t0})
                    ds = ds + jnp.where(
                        coll, jnp.exp(-a_t0) * d_at0 / coll_denom, 0.0
                    )
                    # Fresnel coin with the FULL dR (incidence movement)
                    ds = ds + jnp.where(
                        coin, jnp.nan_to_num(d["refl_r"] * branch), 0.0
                    )
                    contribs.append(ds)
                    # Absorption point moves with the boundary under the
                    # truncated-density reparameterization: correct the
                    # position tangent along the PRE-event direction.
                    ds_rep = jnp.where(coll, dt0 * rep_fac, 0.0)
                    tpx = jnp.nan_to_num(d["px"]) + ds_rep * state["dx"]
                    tpy = jnp.nan_to_num(d["py"]) + ds_rep * state["dy"]
                    tpz = jnp.nan_to_num(d["pz"]) + ds_rep * state["dz"]
                    new_tang.append(
                        jnp.stack([
                            tpx, tpy, tpz,
                            jnp.nan_to_num(d["dx"]),
                            jnp.nan_to_num(d["dy"]),
                            jnp.nan_to_num(d["dz"]),
                            jnp.nan_to_num(d["wav"]),
                        ])
                    )
                pw_tang = jnp.stack(new_tang)
            score = score + jnp.stack(contribs)

        if cfg.score:
            term = jnp.zeros(B, dtype=bool)
            fate_id = jnp.zeros(B, jnp.int32)
            for mask, fid in (
                (r["exit_mask"], EV_EXIT),
                (r["losing"], EV_NONRADIATIVE),
                (r["reacting"], EV_REACT),
                (r["kill_max"], EV_KILL),
                (r["adj_bad"], EV_KILL),
                (r["no_hit_term"], FATE_NO_HIT),
                (budget_kill, EV_KILL),
            ):
                term = term | mask
                fate_id = jnp.where(mask, fid, fate_id)
            idx = jnp.where(term, fate_id, 0)
            vals = jnp.where(term[None, :], score, 0.0)  # [C, B]
            fate_scores = tallies["fate_scores"].at[idx].add(vals.T)
            tallies = dict(tallies)
            tallies["fate_scores"] = fate_scores

        # --- merged recorder tally ------------------------------------
        if cfg.n_recorders > 0:
            sel = r["sel"]
            tnode = r["tnode"]
            angle = jnp.where(
                r["surface_event"], jnp.arccos(r["c_in"]), 0.0
            )
            tlx = jnp.zeros(B, f)
            tly = jnp.zeros(B, f)
            tlz = jnp.zeros(B, f)
            for n in range(N):
                R = W2L[n]
                here = tnode == n
                tlx = jnp.where(
                    here,
                    R[0, 0] * r["px"] + R[0, 1] * r["py"]
                    + R[0, 2] * r["pz"] + R[0, 3],
                    tlx,
                )
                tly = jnp.where(
                    here,
                    R[1, 0] * r["px"] + R[1, 1] * r["py"]
                    + R[1, 2] * r["pz"] + R[1, 3],
                    tly,
                )
                tlz = jnp.where(
                    here,
                    R[2, 0] * r["px"] + R[2, 1] * r["py"]
                    + R[2, 2] * r["pz"] + R[2, 3],
                    tlz,
                )
            new_tallies = _tally(
                tallies, compiled, cfg, sel, tnode, r["have_n"],
                (r["wnx"], r["wny"], r["wnz"]), (tlx, tly, tlz), angle,
                r["wav"], r["trav"], r["dur"],
                score=score if cfg.score else None,
            )
            new_tallies["fates"] = fates
            tallies = new_tallies
        else:
            tallies = dict(tallies)
            tallies["fates"] = fates

        alive = r["alive"]
        out = {
            "px": r["px"], "py": r["py"], "pz": r["pz"],
            "dx": r["dx"], "dy": r["dy"], "dz": r["dz"],
            "wav": r["wav"],
            "trav": r["trav"],
            "dur": r["dur"],
            "source": r["source"],
            "alive": alive,
            "count": count,
            "step": step,
            "k0": pk0,
            "k1": pk1,
            "nevents": nevents,
            "slot": slot,
            "log": log,
            "tallies": tallies,
        }
        if cfg.score:
            out["score"] = score
            if cfg.pathwise:
                out["tang"] = pw_tang

        # --- lane regeneration -----------------------------------------
        if regen is not None:
            pid = state["pid"]
            nxt = state["next"]
            dead = ~alive
            ranks = jnp.cumsum(dead.astype(jnp.uint32)) - jnp.uint32(1)
            cand = nxt + ranks
            refill = dead & (cand < jnp.asarray(regen_total, jnp.uint32))
            pid = jnp.where(refill, cand, pid)
            nxt = nxt + jnp.sum(refill, dtype=jnp.uint32)
            s0, s1 = _key_words(regen_base_key)
            nk0, nk1 = _threefry2x32(s0, s1, pid, jnp.zeros_like(pid))
            epos3, edir3, ewav = _device_emit(
                compiled, cfg, tables, (nk0, nk1), pid
            )
            zero = jnp.zeros(B, f)
            out["px"] = jnp.where(refill, epos3[:, 0], r["px"])
            out["py"] = jnp.where(refill, epos3[:, 1], r["py"])
            out["pz"] = jnp.where(refill, epos3[:, 2], r["pz"])
            out["dx"] = jnp.where(refill, edir3[:, 0], r["dx"])
            out["dy"] = jnp.where(refill, edir3[:, 1], r["dy"])
            out["dz"] = jnp.where(refill, edir3[:, 2], r["dz"])
            out["wav"] = jnp.where(refill, ewav, r["wav"])
            out["trav"] = jnp.where(refill, zero, r["trav"])
            out["dur"] = jnp.where(refill, zero, r["dur"])
            out["source"] = jnp.where(refill, -1, r["source"])
            out["count"] = jnp.where(refill, 0, count)
            out["alive"] = alive | refill
            out["k0"] = nk0
            out["k1"] = nk1
            out["pid"] = pid
            out["next"] = nxt
            if cfg.score:
                out["score"] = jnp.where(refill[None, :], 0.0, score)
                if cfg.pathwise:
                    out["tang"] = jnp.where(
                        refill[None, None, :], 0.0, pw_tang
                    )
            nevents = jnp.where(refill, 0, nevents)
            if cfg.record_every > 0:
                slot = jnp.where(
                    refill,
                    jnp.where(
                        pid % jnp.uint32(cfg.record_every) == 0,
                        (
                            (pid - first_rec) // jnp.uint32(cfg.record_every)
                        ).astype(jnp.int32),
                        cfg.n_slots,
                    ),
                    slot,
                )
            out["slot"] = slot
            tallies = dict(tallies)
            tallies["seen"] = jnp.where(
                refill[:, None], False, tallies["seen"]
            )
            out["tallies"] = tallies
            log, nevents = _record(
                log, nevents, slot, refill, cfg,
                kind=EV_GENERATE, hit=-1, container=-1, adjacent=-1,
                component=-1, source=-1, pos3=epos3, dir3=edir3,
                normal3=None, wavelength=ewav, travelled=zero, duration=zero,
            )
            out["log"] = log
            out["nevents"] = nevents

        return out

    fast_ok = cfg.n_slots == 0 and not cfg.score and not _ABLATE
    if fast_ok:

        def step_fn(state):
            alive = state["alive"]
            count = state["count"] + alive.astype(jnp.int32)
            u = _draw8(
                state["k0"], state["k1"], count.astype(jnp.uint32), f
            )
            return physics_core(
                u, state["px"], state["py"], state["pz"],
                state["dx"], state["dy"], state["dz"],
                state["wav"], state["trav"], state["dur"],
                state["source"], alive, count,
                spec_slots_fn, icdf_fn,
            )

        loop_body = lambda s: body_fast(s, step_fn)  # noqa: E731
    else:
        loop_body = body

    # Two physics steps per while iteration amortise the while_loop's
    # fixed per-iteration overhead (condition reduction + buffer
    # plumbing); ROADMAP Speed 3 re-sweeps the depth on the GPU. Safe
    # by construction: every state update is masked by
    # `alive`, so a step on an all-dead wavefront is a no-op, and
    # regeneration runs inside the body so refills happen between the
    # two halves exactly as they would between iterations.
    state = jax.lax.while_loop(
        cond, lambda s: loop_body(loop_body(s)), state
    )

    # Per-slot event counts from the log itself (a lane's slot changes
    # over time under regeneration, so the final per-lane nevents is
    # not enough).
    if cfg.n_slots > 0:
        counts = jnp.sum(
            state["log"]["ints"][: cfg.n_slots, :, 0] >= 0, axis=1
        ).astype(jnp.int32)
    else:
        counts = jnp.zeros(1, jnp.int32)
    # The per-lane [B, R] `seen` mask is loop state, not a tally: only
    # the additive accumulators leave the loop (and get all-reduced on
    # a mesh).
    tallies = {k: v for k, v in state["tallies"].items() if k != "seen"}
    return tallies, state["log"], counts, state["step"]
