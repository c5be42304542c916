"""Differentiable transport estimators (the beyond-reference path).

The discrete Monte Carlo tracer is not usefully differentiable through
its branch decisions; this module provides smooth, pathwise-
differentiable estimators of transport observables for optimisation
(BASELINE north star: dL/d(concentration) gradients):

* `absorbed_fraction`: expected first-pass absorption of a photon
  bundle in the scene's absorbing node, differentiable w.r.t. a dye
  concentration multiplier via the Beer-Lambert weight
  1 - exp(-c * alpha(lambda) * chord).
* `make_training_step`: a jitted multi-chip SGD step — photon batch
  sharded over the mesh (dp), parameters replicated, loss terms and
  gradients reduced with `psum` (SURVEY §2.3: the scene "model" is
  tiny and replicated; only the photon axis is distributed).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from pvtrace_tpu.engine import compiler as comp
from pvtrace_tpu.light.event import Event


def resolve_pathwise_params(compiled, params):
    """Map user parameter specs to tracer channel specs.

    Accepted spec forms (node by name or preorder index):

    - ``("n", node)`` — refractive index (full hybrid estimator:
      Fresnel-coin likelihood including the Snell/incidence tangent
      term, plus free-flight boundary movement);
    - ``("size", node, axis)`` — box edge length along ``axis``;
    - ``("radius", node)`` — sphere or cylinder radius;
    - ``("length", node)`` — cylinder length.
    """
    resolved = []
    for spec in params:
        kind = spec[0]
        node = spec[1]
        if not isinstance(node, int):
            node = compiled.node_names.index(node)
        gtype = int(compiled.geom_type[node])
        if kind == "n":
            resolved.append(("n", node))
        elif kind == "size":
            if gtype != comp.GEOM_BOX:
                raise ValueError(f"'size' needs a Box node, got type {gtype}")
            resolved.append(("geom", node, int(spec[2])))
        elif kind == "radius":
            if gtype == comp.GEOM_SPHERE:
                resolved.append(("geom", node, 0))
            elif gtype == comp.GEOM_CYLINDER:
                resolved.append(("geom", node, 1))
            else:
                raise ValueError(
                    f"'radius' needs a Sphere or Cylinder node, got {gtype}"
                )
        elif kind == "length":
            if gtype != comp.GEOM_CYLINDER:
                raise ValueError(f"'length' needs a Cylinder node, got {gtype}")
            resolved.append(("geom", node, 0))
        else:
            raise ValueError(f"Unknown pathwise parameter kind {kind!r}")
    return tuple(resolved)


def fate_gradients(scene, num_rays, seed=None, wrt="components",
                   pathwise=None, bundle=16_000_000, center=True,
                   mesh=None, **kwargs):
    """Full multi-bounce gradients of fate fractions from ONE run.

    Score-function (likelihood-ratio) estimator, accumulated on device
    by the wavefront tracer: every free-path sample, component roulette
    and Fresnel coin flip contributes d log p(path)/d theta, and at
    termination the path score is folded into its fate's accumulator,
    so

        d P(fate) / d theta  =  E[ 1{fate} * score_theta ].

    Returns (fractions, gradients): ``fractions[Event]`` is the fate
    fraction; ``gradients[Event]`` depends on ``wrt``:

    - ``"components"`` (default): [n_components] array of
      d fraction / d log(component coefficient scale). Exact in
      expectation — discrete events don't depend on the scales.
    - ``"refractive_index"``: [n_nodes] array of d fraction / d n_k
      from the Fresnel reflect/transmit probabilities (the coin-flip
      likelihood term). The deterministic Snell bending of transmitted
      directions is NOT differentiated, so this is the full derivative
      at normal incidence and the probability-path partial otherwise.
    - ``"all"``: [n_components + n_nodes], both blocks concatenated.
    - ``"pathwise"``: [len(pathwise)] — hybrid pathwise channels for the
      parameters given via ``pathwise=[...]`` (see
      `resolve_pathwise_params` for the spec forms). Unlike
      ``"refractive_index"``, an ``("n", node)`` pathwise channel is the
      COMPLETE derivative at any incidence: the Fresnel coin term uses
      the full dR (Snell/incidence movement included) and boundary
      motion enters through free-flight survival likelihoods, with
      direction/position tangents propagated photon-by-photon through
      every deterministic reflection and refraction.

    ``bundle`` caps the photons per device call: large runs stream in
    exact-union bundles and the [fate, channel] score sums accumulate in
    float64 on the host — at 10^8 photons a single f32 on-device
    accumulator reaches ~10^7 magnitude where per-step adds of O(10)
    fall below the ulp and quantize away. ``center=True`` subtracts the
    zero-expectation control variate p_fate * mean(score): E[score] = 0
    over the path measure, so centring is unbiased and removes the
    common-mode score noise shared by every fate.

    ``mesh`` shards the photon axis over a device mesh
    (``parallel.make_photon_mesh()``): each chip traces its slice and
    the score accumulators are psum-reduced — the gradient all-reduce
    of SURVEY §2.3. `num_rays` (and `bundle`) must be a multiple of
    the mesh size; per-photon keys fold the global photon index, so the sharded
    estimator equals the single-device one (bitwise for the fate
    counts, up to summation order for the float score sums).

    kwargs pass through to ``engine.simulate`` (lanes, dtype, ...).
    """
    from pvtrace_tpu.engine.api import simulate
    from pvtrace_tpu.engine.compiler import compile_scene

    compiled = kwargs.pop("compiled", None)
    if compiled is None:
        compiled = compile_scene(scene)
    pw = (
        resolve_pathwise_params(compiled, pathwise) if pathwise else ()
    )
    if seed is None:
        seed = int(np.random.randint(0, 2 ** 31 - 1))
    if mesh is not None:
        from pvtrace_tpu.parallel.shard import shard_simulate

        n_dev = mesh.devices.size
        if num_rays % n_dev != 0:
            raise ValueError(
                f"num_rays ({num_rays}) must be a multiple of the mesh size ({n_dev})."
            )
        if bundle:
            bundle = max(n_dev, bundle - bundle % n_dev)

    n_comps = int(compiled.n_components)
    n_nodes = len(compiled.nodes)
    scores_sum = None
    fates_sum = None
    traced = 0
    while traced < num_rays:
        n_call = (
            num_rays - traced if not bundle else min(bundle, num_rays - traced)
        )
        if mesh is not None:
            data = shard_simulate(
                scene, n_call, mesh, seed=seed, index_offset=traced,
                score=True, pathwise=pw, compiled=compiled, **kwargs
            )
        else:
            data = simulate(
                scene, n_call, seed=seed, index_offset=traced,
                record_every=0, score=True, pathwise=pw,
                compiled=compiled, **kwargs
            ).data
        part = np.asarray(data["fate_scores"], dtype=np.float64)
        fate_part = np.asarray(data["fates"], dtype=np.float64)
        scores_sum = part if scores_sum is None else scores_sum + part
        fates_sum = fate_part if fates_sum is None else fates_sum + fate_part
        traced += n_call

    scores = _slice_channels(scores_sum, n_comps, wrt, n_nodes=n_nodes)
    if center:
        # Unbiased control variate: subtract p_fate * (sum of all path
        # scores) — zero in expectation, correlated with the noise.
        total_score = scores.sum(axis=0, keepdims=True)
        scores = scores - fates_sum[:, None] / num_rays * total_score
    fractions, gradients = {}, {}
    for event in (Event.EXIT, Event.NONRADIATIVE, Event.REACT, Event.KILL):
        fractions[event] = fates_sum[event.value] / num_rays
        gradients[event] = scores[event.value] / num_rays
    return fractions, gradients


def _slice_channels(scores, n_comps, wrt, n_nodes=None):
    """Select score channels: components block, node-n block, pathwise
    block, or everything."""
    if wrt == "components":
        return scores[..., :n_comps]
    if wrt == "refractive_index":
        if n_nodes is None:
            return scores[..., n_comps:]
        return scores[..., n_comps:n_comps + n_nodes]
    if wrt == "pathwise":
        if n_nodes is None:
            raise ValueError("wrt='pathwise' requires channel counts")
        return scores[..., n_comps + n_nodes:]
    if wrt == "all":
        return scores
    raise ValueError(
        "wrt must be 'components', 'refractive_index', 'pathwise' or "
        f"'all'; got {wrt!r}"
    )


def _absorbing_nodes(compiled):
    nodes = [
        i for i in range(len(compiled.nodes)) if compiled.comp_count[i] > 0
    ]
    if not nodes:
        raise ValueError("Scene has no absorbing node.")
    return nodes


def _chord_fn(compiled, node):
    """Returns fn(pos, dir) -> straight-line chord length through `node`
    (world-frame inputs; rigid transform + analytic interval solve)."""
    R = np.asarray(compiled.world_to_local[node], dtype=np.float32)
    gtype = int(compiled.geom_type[node])
    gp = np.asarray(compiled.geom_params[node], dtype=np.float64)

    def chord(pos, direction):
        # HIGHEST: a float32 product may otherwise run in TF32 on GPUs.
        rot = functools.partial(
            jnp.matmul, precision=jax.lax.Precision.HIGHEST
        )
        o = rot(pos, R[:3, :3].T) + R[:3, 3]
        d = rot(direction, R[:3, :3].T)
        if gtype == comp.GEOM_BOX:
            half = jnp.asarray(0.5 * gp[:3], jnp.float32)
            safe = jnp.where(jnp.abs(d) < 1e-20, 1e-20, d)
            t1 = (-half - o) / safe
            t2 = (half - o) / safe
            tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
            tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
        elif gtype == comp.GEOM_SPHERE:
            r = float(gp[0])
            b = 2.0 * jnp.sum(d * o, axis=-1)
            cq = jnp.sum(o * o, axis=-1) - r * r
            disc = b * b - 4.0 * cq
            sq = jnp.sqrt(jnp.clip(disc, 0.0, None))
            tmin = (-b - sq) / 2.0
            tmax = (-b + sq) / 2.0
            tmax = jnp.where(disc >= 0, tmax, -1.0)
        elif gtype == comp.GEOM_CYLINDER:
            # Capped z-cylinder chord: intersect the infinite-barrel
            # quadratic interval with the end-cap z-slab interval.
            length, radius = float(gp[0]), float(gp[1])
            big = jnp.asarray(1e30, jnp.float32)
            ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
            dx_, dy_, dz_ = d[..., 0], d[..., 1], d[..., 2]
            a = dx_ * dx_ + dy_ * dy_
            b = 2.0 * (ox * dx_ + oy * dy_)
            cq = ox * ox + oy * oy - radius * radius
            disc = b * b - 4.0 * a * cq
            sq = jnp.sqrt(jnp.clip(disc, 0.0, None))
            a_safe = jnp.maximum(a, 1e-20)
            axial = a < 1e-20  # ray parallel to the axis
            in_barrel = cq < 0.0
            bar_lo = jnp.where(
                axial, jnp.where(in_barrel, -big, big), (-b - sq) / (2 * a_safe)
            )
            bar_hi = jnp.where(
                axial, jnp.where(in_barrel, big, -big), (-b + sq) / (2 * a_safe)
            )
            bar_hi = jnp.where(~axial & (disc < 0.0), -big, bar_hi)
            half = 0.5 * length
            dz_safe = jnp.where(jnp.abs(dz_) < 1e-20, 1e-20, dz_)
            z1 = (-half - oz) / dz_safe
            z2 = (half - oz) / dz_safe
            flat = jnp.abs(dz_) < 1e-20  # ray parallel to the caps
            in_slab = jnp.abs(oz) < half
            cap_lo = jnp.where(
                flat, jnp.where(in_slab, -big, big), jnp.minimum(z1, z2)
            )
            cap_hi = jnp.where(
                flat, jnp.where(in_slab, big, -big), jnp.maximum(z1, z2)
            )
            tmin = jnp.maximum(bar_lo, cap_lo)
            tmax = jnp.minimum(bar_hi, cap_hi)
        else:
            raise NotImplementedError(f"chord for geometry type {gtype}")
        inside = jnp.clip(tmax - jnp.maximum(tmin, 0.0), 0.0, None)
        return jnp.where(tmax > 0.0, inside, 0.0)

    return chord


def absorbed_fraction_fn(compiled):
    """Returns fn(params, pos, dir, wav) -> per-photon absorbed weight.

    First-pass straight-line Beer-Lambert estimator, differentiable
    w.r.t. params["log_concentration"] (a global scale on every
    absorbing component): the optical depth sums c * alpha_n(lambda) *
    chord_n over EVERY absorbing node, assuming unbent rays — exact for
    index-matched scenes, a smooth surrogate otherwise (use
    `fate_gradients` for the full multi-bounce estimator).
    """
    x0, dx_grid, L = compiled.grid_x0, compiled.grid_dx, compiled.grid_n
    parts = [
        (_chord_fn(compiled, node),
         jnp.asarray(compiled.node_alpha[node], dtype=jnp.float32))
        for node in _absorbing_nodes(compiled)
    ]

    def weight(params, pos, direction, wav):
        c = jnp.exp(params["log_concentration"])
        posf = jnp.clip((wav - x0) / dx_grid, 0.0, L - 1.0)
        i0 = jnp.clip(posf.astype(jnp.int32), 0, L - 2)
        frac = posf - i0
        depth = 0.0
        for chord, alpha_row in parts:
            alpha = alpha_row[i0] * (1 - frac) + alpha_row[i0 + 1] * frac
            depth = depth + alpha * chord(pos, direction)
        return 1.0 - jnp.exp(-c * depth)

    return weight


def optimize_concentration(scene_builder, target, num_rays=200_000,
                           iters=6, lr=4.0, seed=0, component=0,
                           event=None, verbose=False, **kwargs):
    """Host-loop gradient descent on log(dye concentration) using the
    UNBIASED multi-bounce score estimator (no straight-line surrogate).

    `scene_builder(scale)` must rebuild the scene with every absorbing
    coefficient of the target component multiplied by `scale`. Each
    iteration traces `num_rays` on the device, reads P(fate) and
    dP/dlog(scale) from one score run, and descends the squared error
    to `target`. Rebuilding the scene re-bakes the compiled tables, so
    each iteration pays one compile — use `make_training_step` when you
    want a fully jitted per-step update and can accept its straight-line
    first-pass surrogate.

    Returns (log_scale, history) with history rows
    (log_scale, fraction, loss).
    """
    if event is None:
        event = Event.NONRADIATIVE
    log_scale = 0.0
    history = []
    for i in range(iters):
        scene = scene_builder(float(np.exp(log_scale)))
        fractions, gradients = fate_gradients(
            scene, num_rays, seed=seed + i, **kwargs
        )
        p = float(fractions[event])
        g = float(gradients[event][component])
        loss = (p - target) ** 2
        history.append((log_scale, p, loss))
        if verbose:
            print(f"iter {i}: log_scale={log_scale:+.4f} "
                  f"P={p:.4f} loss={loss:.6f}")
        log_scale -= lr * 2.0 * (p - target) * g
    return log_scale, history


def make_training_step(compiled, mesh, axis_name="photons", target=0.8,
                       lr=0.1):
    """Jitted multi-chip SGD step on the dye concentration.

    fn(params, pos, dir, wav, key) -> (new_params, loss); the photon
    batch is sharded over `mesh`, gradients psum-reduced.

    NOTE: the loss differentiates the smooth first-pass straight-line
    Beer-Lambert surrogate (`absorbed_fraction_fn`) — exact for
    index-matched scenes, systematically biased when refraction bends
    rays (e.g. the n=1.5 LSC). For unbiased multi-bounce gradients use
    `fate_gradients` / `optimize_concentration`, which pay one compile
    per concentration value instead of being fully jitted.
    """
    weight = absorbed_fraction_fn(compiled)
    n_dev = mesh.devices.size

    def loss_fn(params, pos, direction, wav):
        def per_shard(params, pos, direction, wav):
            w = weight(params, pos, direction, wav)
            local = jnp.sum(w)
            count = jnp.asarray(w.shape[0], jnp.float32)
            total = jax.lax.psum(local, axis_name)
            n = jax.lax.psum(count, axis_name)
            mean = total / n
            return (mean - target) ** 2

        return jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(), P(axis_name), P(axis_name), P(axis_name)),
            out_specs=P(),
        )(params, pos, direction, wav)

    @jax.jit
    def step(params, pos, direction, wav, key):
        loss, grads = jax.value_and_grad(loss_fn)(params, pos, direction, wav)
        new_params = jax.tree_util.tree_map(
            lambda p, g: p - lr * g, params, grads
        )
        return new_params, loss

    return step
