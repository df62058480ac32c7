"""The wavefront path-tracing integrator.

This is the wavefront re-design of the reference's OptiX megakernel
(`__raygen__rg` / `__closesthit__radiance` / `__miss__radiance`,
reference optixSphere.cu:297-436, 616-872, 531-567).  Where the reference
gives each CUDA thread one pixel and lets hardware SER re-sort divergent
rays (cu:113-115), here the whole frame is a flat SoA ray batch and every
bounce is one divergence-free vector step:

    while any lane alive:
        hit   = intersect(all lanes)          # batched Möller–Trumbore/BVH
        shade = closest-hit math, all lanes   # masked selects, no branches
        miss  = environment lookup, all lanes
        russian-roulette + state update       # masked writes

Dead lanes ride along as masked no-ops (the "fixed-slot pool" strategy from
SURVEY.md §7 — cheaper than true compaction at these scene sizes); the loop
exits as soon as every lane terminates, so converged batches stop early.

The estimator clones the reference exactly (cfg.rr_mode="reference"),
including its quirks:
  * `path_rgb = payload.radiance` then `path_rgb /= p` at termination
    (cu:376-387) — the whole path's radiance is divided by the *last*
    survival probability;
  * the lobe-selection estimator `brdf = P_s*(spec/spdf) + (1-P_s)*
    (albedo/dpdf)` evaluated identically regardless of the sampled lobe
    (cu:800), with the throughput cosine taken against the *specular*
    direction even for diffuse bounces (`IdotN`, cu:776, 860);
  * glass bounces bypass the attenuation update entirely (cu:804-856);
  * max_depth counts down and termination triggers at depth <= 0 in the
    closest-hit program (cu:360, 395, 738).
`cfg.rr_mode="standard"` instead applies textbook unbiased Russian roulette.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from pathtracer.config import RenderConfig
from pathtracer.ops.intersect import Hit, intersect_scene
from pathtracer.render import bsdf
from pathtracer.render.envmap import eval_env
from pathtracer.render.texsample import material_property
from pathtracer.scene.scene import Scene
from pathtracer.utils import math as vm
from pathtracer.utils import rng


# ---------------------------------------------------------------------------
# Ray generation (reference __raygen__rg, cu:297-347)
# ---------------------------------------------------------------------------

def generate_camera_rays(
    cam: dict,
    pixel_x: jnp.ndarray,   # [N] i32
    pixel_y: jnp.ndarray,   # [N] i32
    seeds: jnp.ndarray,     # [N] u32
    cfg: RenderConfig,
):
    """Primary rays with sub-pixel jitter AA and optional thin-lens DOF.

    cam: {"eye","U","V","W"} float32 [3] arrays (sutil UVW frame).
    Returns (origins [N,3], directions [N,3], seeds).
    """
    eye, u_vec, v_vec, w_vec = cam["eye"], cam["U"], cam["V"], cam["W"]
    width = jnp.float32(cfg.width)
    height = jnp.float32(cfg.height)

    seeds, jx, jy = rng.uniform2(seeds)
    # NDC in [-1,1] (cu:332)
    dx = 2.0 * (pixel_x.astype(jnp.float32) + jx) / width - 1.0
    dy = 2.0 * (pixel_y.astype(jnp.float32) + jy) / height - 1.0

    target = dx[:, None] * u_vec + dy[:, None] * v_vec + w_vec

    if cfg.dof:
        # defocus_disk_sample (cu:279-294).  The reference passes the seed
        # *by value*, so these two draws do not advance the main chain —
        # reproduced via a discarded local chain.
        local = seeds
        local, r_u = rng.uniform(local)
        local, theta_u = rng.uniform(local)
        r = jnp.sqrt(r_u)
        theta = 2.0 * jnp.pi * theta_u
        # radius ~ u^(1/4): the reference applies sqrt twice (cu:282, 288)
        radius = cfg.dof_blurriness * jnp.sqrt(r)
        off = (radius * jnp.cos(theta))[:, None] * u_vec + (
            radius * jnp.sin(theta)
        )[:, None] * v_vec
        directions = vm.normalize(cfg.focus_distance * target - off)
        origins = off + eye
    else:
        directions = vm.normalize(target)
        # + 0*directions: ties origins to the per-ray data so shard_map's
        # varying-axes tracking sees them as device-varying like directions.
        origins = jnp.broadcast_to(eye, directions.shape) + 0.0 * directions

    return origins, directions, seeds


# ---------------------------------------------------------------------------
# Closest-hit shading (reference __closesthit__radiance, cu:616-872)
# ---------------------------------------------------------------------------

def _shade(scene: Scene, cfg: RenderConfig, hit: Hit, origins, directions, seeds, depth):
    """Vectorized closest-hit program.  Everything computed for all lanes;
    the caller selects with hit/terminated masks.

    Returns dict with: new_origin, new_direction, new_attenuation_factor
    ([N,3], multiplied into attenuation where `att_ok`), att_ok [N],
    add_radiance_emissive [N,3] (times attenuation, where `emissive`),
    emissive [N], done [N], seeds.
    """
    from pathtracer.scene import scene as S

    prim = jnp.maximum(hit.prim, 0)  # safe gather index for miss lanes
    # One packed row lookup per table: triangle attributes ([T,32]) and
    # material constants ([M,32]).
    ta = scene.tri_attrs[prim]                         # [N,32]
    tri_v = ta[:, S.TRI_V].reshape(-1, 3, 3)
    tri_n = ta[:, S.TRI_N].reshape(-1, 3, 3)
    tri_uv = ta[:, S.TRI_UV].reshape(-1, 3, 2)
    mat = ta[:, S.TRI_MAT].astype(jnp.int32)           # [N]
    m = scene.materials
    ma = m.attrs[mat]                                  # [N,32]

    ray_dir = directions
    v0, v1, v2 = tri_v[:, 0], tri_v[:, 1], tri_v[:, 2]

    # Flat geometric normal, face-forwarded against the ray (cu:637-638).
    flat_n = vm.normalize(jnp.cross(v1 - v0, v2 - v0))
    flat_n = vm.faceforward(flat_n, -ray_dir, flat_n)

    # Barycentric interpolation (cu:648-662); OptiX layout: (beta, gamma).
    beta = hit.bary[:, 0]
    gamma = hit.bary[:, 1]
    alpha_b = 1.0 - beta - gamma
    w_interp = jnp.stack([alpha_b, beta, gamma], axis=-1)     # [N,3]

    uv = vm.interp3(w_interp, tri_uv)           # [N,2]
    tex_u = uv[:, 0]
    tex_v = (1.0 - uv[:, 1]) if cfg.flip_v else uv[:, 1]      # cu:659

    normal_raw = vm.interp3(w_interp, tri_n)
    degenerate = vm.length(normal_raw) <= 0.01                # cu:664-669
    normal = vm.normalize(normal_raw)
    # Backfacing smooth normal -> flat normal (cu:673-675).
    normal = jnp.where((vm.dot(normal, ray_dir) > 0.0)[:, None], flat_n, normal)

    hit_pos = origins + hit.t[:, None] * ray_dir

    # ---- texture-driven material properties (cu:682-717) -------------
    has_map = ma[:, S.MAT_HAS_MAP] > 0.5               # [N,4]
    # The bundle gather is issue-bound per ROW (~13.4 ns each from the
    # HBM pool — the single biggest shade cost at 131k lanes), and lanes
    # whose material carries no maps at all consume only the constant
    # fallbacks: exclude them from the gather along with miss lanes.
    any_map = jnp.any(has_map, axis=1)                 # [N]
    if m.bundled:
        # All maps of a material share dims: ONE gather serves all four.
        from pathtracer.render.texsample import sample_bundle

        # Texture LOD: when a mip ladder exists (only built for pools
        # beyond ~16 MB), explicit "mip" swaps the whole gather onto
        # the small pool and "split" keeps full-res for primary
        # segments.  "auto" resolves to OFF: the mip costs visible
        # texture detail (see config.texture_lod).
        lod = cfg.texture_lod
        use_mip = m.mip_level > 0 and lod in ("mip", "split")
        mip_pools = (
            (
                m.texture_bundles_mip,
                ma[:, S.MAT_MIP_OFFSET].astype(jnp.int32),
                ma[:, S.MAT_MIP_WIDTH].astype(jnp.int32),
                ma[:, S.MAT_MIP_HEIGHT].astype(jnp.int32),
                m.mip_scrambled,
                m.mip_pow2_dims,
            )
            if use_mip
            else None
        )
        base_pools = (
            m.texture_bundles,
            ma[:, S.MAT_BUNDLE_OFFSET].astype(jnp.int32),
            ma[:, S.MAT_BUNDLE_WIDTH].astype(jnp.int32),
            ma[:, S.MAT_BUNDLE_HEIGHT].astype(jnp.int32),
            m.bundled_scrambled,
            m.bundled_pow2_dims,
        )

        def _bundle(pools, active):
            pool, off, w, h, scr, p2 = pools
            return sample_bundle(
                pool, off, w, h, tex_u, tex_v,
                morton=m.bundled_morton and pools is base_pools,
                scrambled=scr,
                pow2_dims=p2,
                active=active,  # inactive lanes spread over hashed rows
            )

        if use_mip and lod != "split":
            bundle_samples = _bundle(mip_pools, hit.hit & any_map)
        elif use_mip:
            # split: primary segments (depth == cfg.max_depth) full-res.
            primary = depth >= jnp.int32(cfg.max_depth)
            full = _bundle(base_pools, hit.hit & any_map & primary)
            mips = _bundle(mip_pools, hit.hit & any_map & ~primary)
            bundle_samples = [
                jnp.where(primary[:, None], f, mp)
                for f, mp in zip(full, mips)
            ]
        else:
            bundle_samples = _bundle(base_pools, hit.hit & any_map)

        def prop(kind: int, fallback):
            return jnp.where(
                has_map[:, kind][:, None], bundle_samples[kind], fallback
            )

    else:
        pool = m.texture_quads
        map_off = ma[:, S.MAT_MAP_OFFSET].astype(jnp.int32)
        map_w = ma[:, S.MAT_MAP_WIDTH].astype(jnp.int32)
        map_h = ma[:, S.MAT_MAP_HEIGHT].astype(jnp.int32)

        def prop(kind: int, fallback):
            return material_property(
                pool,
                has_map[:, kind],
                map_off[:, kind],
                map_w[:, kind],
                map_h[:, kind],
                fallback,
                tex_u,
                tex_v,
            )

    diffuse_albedo = prop(0, ma[:, S.MAT_DIFFUSE])

    nmap_fallback = jnp.broadcast_to(
        jnp.array([0.0, 1.0, 0.0], jnp.float32), normal.shape
    )
    nmap = prop(2, nmap_fallback)
    has_nmap = has_map[:, 2]
    # Decode 2n-1 and swap Y/Z channels (cu:691-694).
    decoded = vm.normalize(2.0 * nmap - 1.0)
    decoded = jnp.stack([decoded[..., 0], decoded[..., 2], decoded[..., 1]], axis=-1)
    nmap = jnp.where(has_nmap[:, None], decoded, nmap)
    # Rotate into the shading frame and blend at fixed strength (cu:697-701).
    tang, binorm = vm.onb_from_normal(normal)
    nmap_world = vm.onb_transform(nmap, tang, normal, binorm)
    s = cfg.normal_map_strength
    normal = vm.normalize(s * nmap_world + (1.0 - s) * normal)

    specular_albedo = diffuse_albedo                          # cu:702
    emission_color = ma[:, S.MAT_EMISSION]                    # [N,3]

    roughness = prop(1, jnp.broadcast_to(ma[:, S.MAT_ROUGHNESS, None], (mat.shape[0], 3)))[:, 0]
    metallicity = prop(3, jnp.broadcast_to(ma[:, S.MAT_METALLIC, None], (mat.shape[0], 3)))[:, 0]
    transparency = ma[:, S.MAT_TRANSPARENT]
    # Per-material IOR (MTL Ni) where specified; cfg.ior (reference's
    # hard-coded 1.5, cu:717) otherwise.
    mat_ior = ma[:, S.MAT_IOR]
    ior = jnp.where(mat_ior > 0.0, mat_ior, jnp.float32(cfg.ior))

    # Emissive hit terminates the path (cu:725-731).
    emissive = vm.length(emission_color) > 0.0001

    if cfg.seed_advance_quirk:
        seeds, _ = rng.random_in_unit_sphere(seeds)           # cu:733

    roughness = jnp.clip(roughness, cfg.roughness_min, cfg.roughness_max)
    depth_done = depth <= 0                                   # cu:738

    # ---- GGX importance sampling (cu:740-757) -------------------------
    seeds, r1, r2 = rng.uniform2(seeds)
    alpha = roughness * roughness
    half_local = bsdf.ggx_importance_sample(r1, r2, alpha)
    tang2, binorm2 = vm.onb_from_normal(normal)
    half_vec = vm.onb_transform(half_local, tang2, normal, binorm2)

    light_dir = vm.reflect(ray_dir, half_vec)
    seeds, r3, r4 = rng.uniform2(seeds)
    light_dir_diffuse = vm.onb_transform(
        rng.cosine_sample_hemisphere(r3, r4), tang2, normal, binorm2
    )

    # ---- specular BRDF (cu:759-768) -----------------------------------
    f0_scalar = ((1.0 - ior) / (1.0 + ior)) ** 2          # [N]
    f0 = jnp.broadcast_to(f0_scalar[:, None], diffuse_albedo.shape)
    f0 = vm.lerp(f0, specular_albedo, metallicity[:, None])
    ndotv_raw = vm.dot(normal, -ray_dir)
    f_vec = bsdf.fresnel_schlick(jnp.maximum(ndotv_raw, 0.0), f0)
    d_term = bsdf.d_ggx(normal, half_vec, alpha)
    g_term = bsdf.g_smith(alpha, normal, -ray_dir, light_dir)
    denom = 4.0 * jnp.abs(ndotv_raw) * jnp.abs(vm.dot(normal, light_dir))
    brdf_specular = f_vec * (d_term * g_term / jnp.maximum(denom, 1e-10))[:, None]

    ndoth = jnp.maximum(vm.dot(normal, half_vec), 1e-10)
    vdoth = jnp.maximum(vm.dot(-ray_dir, half_vec), 1e-10)
    ndotv = jnp.maximum(ndotv_raw, 0.0)
    idotn = jnp.abs(vm.dot(normal, vm.normalize(light_dir)))  # cu:776 (always
    #                                           the *specular* direction)
    f_blend = bsdf.fresnel_schlick_scalar(ndotv, ior)

    # ---- lobe selection (cu:779-796) -----------------------------------
    spec_prob = metallicity + (1.0 - metallicity) * f_blend
    spdf = bsdf.ggx_pdf(d_term, ndoth, vdoth)
    dpdf = 1.0 / jnp.pi
    seeds, u_lobe = rng.uniform(seeds)
    choose_spec = u_lobe < spec_prob
    dir_surface = jnp.where(
        choose_spec[:, None],
        vm.normalize(light_dir),
        vm.normalize(light_dir_diffuse),
    )

    # Deterministic two-lobe blend (cu:800) — evaluated the same whichever
    # lobe was sampled.
    brdf_combined = (
        spec_prob[:, None] * (brdf_specular / jnp.maximum(spdf, 1e-20)[:, None])
        + (1.0 - spec_prob)[:, None] * (diffuse_albedo / dpdf)
    )

    # ---- glass branch (cu:804-856) --------------------------------------
    glass = transparency > 0.5
    cos_theta_i = vm.dot(normal, -ray_dir)
    inside = cos_theta_i < 0.0
    cos_i = jnp.abs(cos_theta_i)
    n_glass = jnp.where(inside[:, None], -normal, normal)
    eta_passed = jnp.where(inside, 1.0 / ior, ior)
    reflectance = bsdf.fresnel_schlick_scalar(cos_i, ior)     # always `ior`
    seeds, u_reflect = rng.uniform(seeds)
    # Reflection reuses the earlier GGX half-vector (same r1/r2/alpha/onb,
    # cu:832-837) — i.e. exactly `light_dir`.
    refr_dir, _tir = vm.refract(ray_dir, n_glass, eta_passed)
    seeds, sphere_pt = rng.random_in_unit_sphere(seeds)
    # NOTE: the reference leaves the perturbed refraction unnormalized
    # (its `normalize(refract_dir);` is a no-op statement, cu:847).
    refr_perturbed = refr_dir + cfg.glass_roughness_perturb * alpha[:, None] * sphere_pt
    glass_dir = jnp.where((u_reflect < reflectance)[:, None], light_dir, refr_perturbed)

    # ---- combine ---------------------------------------------------------
    new_direction = jnp.where(glass[:, None], glass_dir, dir_surface)
    brdf_ok = vm.length(brdf_combined) >= 1e-10               # cu:859
    att_factor = brdf_combined * idotn[:, None]               # cu:860
    att_ok = brdf_ok & ~glass & ~emissive & ~degenerate

    done = degenerate | emissive | depth_done

    return dict(
        new_origin=hit_pos,
        new_direction=new_direction,
        att_factor=att_factor,
        att_ok=att_ok,
        emission=emission_color,
        emissive=emissive & ~degenerate,
        degenerate=degenerate,
        done=done,
        seeds=seeds,
        # extras for next-event estimation (env importance sampling)
        normal=normal,
        diffuse_albedo=diffuse_albedo,
        glass=glass,
        choose_spec=choose_spec,
        spec_prob=spec_prob,
        idotn=idotn,
        brdf_combined=brdf_combined,
        # extras for spec-lobe MIS (cfg.nee_mis_spec); dead-code
        # eliminated when unused
        spec_dir=vm.normalize(light_dir),
        spec_pdf=spdf,
        f_vec=f_vec,
        alpha=alpha,
    )


# ---------------------------------------------------------------------------
# Deferred (hit-compacted) shading
# ---------------------------------------------------------------------------

# f32 rows: origin 3, direction 3, depth 1, t 1, prim 1, bary 2 (ints ride
# as exact small floats — never bitcast: arbitrary int bit patterns are
# NaN payloads, which float copies need not preserve).
# Seeds are full-range u32 and travel in a separate integer-typed table.
_PACK_IN_COLS = 16
_PACK_OUT_COLS = 16  # new_origin 3, new_direction 3, att_factor 3, emission 3, flags 1


def _shade_deferred(scene: Scene, cfg: RenderConfig, hit: Hit, origins, directions, seeds, depth):
    """Hit-compacted `_shade`: run the closest-hit program only on (dense
    chunks of) lanes that actually hit geometry.

    The texture-bundle gather and the GGX/normal-map math run for every
    lane, but on a typical scene most traced segments are env misses that
    throw that work away.  This is the wavefront version of the shade stage OptiX
    gets from SER + separate CH launches (reference optixSphere.cu:113-118
    re-sorts; here we compact):

      1. prefix-sum the hit mask -> each hit lane's dense slot;
      2. scatter a packed 16-column shade-input row per hit lane
         (scatters with unique indices);
      3. shade `ceil(n_hit / C)` dense C-lane chunks (dynamic trip count;
         a chunk's inputs are a contiguous dynamic_slice, NOT a gather);
      4. scatter each chunk's packed outputs back to its source lanes.

    Same math and per-lane RNG chain as `_shade` (miss lanes never
    consumed their _shade draws — callers select seeds under the hit
    mask); outputs match the dense schedule to within XLA's
    shape-dependent rounding (~1 ULP: fusion/FMA choices differ for
    chunk-shaped arrays).  Returns the same dict as `_shade` restricted to
    the fields the non-NEE callers consume; miss lanes hold zeros
    (callers mask on hit).
    """
    n = origins.shape[0]
    c = max(1024, -(-(n // cfg.deferred_chunk_div) // 1024) * 1024)
    c = min(c, n)

    hitm = hit.hit
    pos = jnp.cumsum(hitm.astype(jnp.int32))
    n_hit = pos[-1]
    slot = pos - 1
    lane_ids = jnp.arange(n, dtype=jnp.int32)

    # lane_of_slot[s] = source lane of dense slot s; row n = sink for the
    # garbage tail of the last chunk (init n, miss lanes dropped).
    dest = jnp.where(hitm, slot, n + 1)  # n+1 = out of range -> dropped
    lane_of_slot = jnp.full((n + 1,), n, jnp.int32).at[dest].set(
        lane_ids, mode="drop"
    )

    packed_in = jnp.zeros((n + 1, _PACK_IN_COLS), jnp.float32)
    packed_in = packed_in.at[:n].set(
        jnp.concatenate(
            [
                origins,
                directions,
                depth.astype(jnp.float32)[:, None],
                hit.t[:, None],
                jnp.maximum(hit.prim, 0).astype(jnp.float32)[:, None],
                hit.bary,
                jnp.zeros((n, _PACK_IN_COLS - 11), jnp.float32),
            ],
            axis=-1,
        )
    )
    seeds_in = jnp.zeros((n + 1, 1), jnp.uint32).at[:n, 0].set(seeds)

    def chunk(carry):
        k, out_buf, seeds_buf = carry
        # INVARIANT (load-bearing): k*c + c can exceed the (n+1)-row
        # lane_of_slot table on the last chunk, and dynamic_slice then
        # CLAMPS the start down — re-reading up to c-1 already-processed
        # slots.  That is correct only because re-shading a lane is
        # bit-identical (same packed inputs, same seeds) and the
        # .at[idx].set writes are idempotent.  Any per-chunk state (e.g.
        # a chunk-salted RNG draw) would silently break this; if that is
        # ever needed, pad lane_of_slot to a multiple of c instead.
        idx = jax.lax.dynamic_slice(lane_of_slot, (k * c,), (c,))   # [C]
        rows = packed_in[idx]                                       # [C,16]
        s_c = seeds_in[idx, 0]
        o_c = rows[:, 0:3]
        d_c = rows[:, 3:6]
        dep_c = rows[:, 6].astype(jnp.int32)
        hit_c = Hit(
            t=rows[:, 7],
            prim=rows[:, 8].astype(jnp.int32),
            bary=rows[:, 9:11],
            hit=idx < n,
        )
        sh = _shade(scene, cfg, hit_c, o_c, d_c, s_c, dep_c)
        flags = (
            sh["att_ok"].astype(jnp.int32)
            | (sh["emissive"].astype(jnp.int32) << 1)
            | (sh["degenerate"].astype(jnp.int32) << 2)
            | (sh["done"].astype(jnp.int32) << 3)
        )
        packed_out = jnp.concatenate(
            [
                sh["new_origin"],
                sh["new_direction"],
                sh["att_factor"],
                sh["emission"],
                flags.astype(jnp.float32)[:, None],
                jnp.zeros((c, _PACK_OUT_COLS - 13), jnp.float32),
            ],
            axis=-1,
        )
        # Garbage tail slots carry idx == n -> land on the sink row.
        out_buf = out_buf.at[idx].set(packed_out)
        seeds_buf = seeds_buf.at[idx, 0].set(sh["seeds"])
        return k + 1, out_buf, seeds_buf

    out0 = jnp.zeros((n + 1, _PACK_OUT_COLS), jnp.float32)
    seeds0 = jnp.zeros((n + 1, 1), jnp.uint32)
    _, out_buf, seeds_buf = jax.lax.while_loop(
        lambda kc: kc[0] * c < n_hit, chunk, (jnp.int32(0), out0, seeds0)
    )
    out = out_buf[:n]
    flags = out[:, 12].astype(jnp.int32)
    return dict(
        new_origin=out[:, 0:3],
        new_direction=out[:, 3:6],
        att_factor=out[:, 6:9],
        emission=out[:, 9:12],
        seeds=seeds_buf[:n, 0],
        att_ok=(flags & 1) > 0,
        emissive=(flags & 2) > 0,
        degenerate=(flags & 4) > 0,
        done=(flags & 8) > 0,
    )


# ---------------------------------------------------------------------------
# The bounce loop (reference raygen loop, cu:362-396)
# ---------------------------------------------------------------------------

def nee_mq_on(cfg) -> bool:
    """Resolve cfg.nee_multi_queue for this render ("auto" = off; "on"
    stays available for measurement)."""
    if not cfg.env_importance_sampling:
        return False
    return cfg.nee_multi_queue == "on"


def make_pending(origins) -> dict:
    """Inactive deferred-shadow state (multi-queue NEE), shaped like the
    lane pool.  *_like derivations keep shard_map varying axes right."""
    return dict(
        active=jnp.zeros_like(origins[:, 0], dtype=bool),
        origin=jnp.zeros_like(origins),
        dir=jnp.zeros_like(origins).at[:, 0].set(1.0),
        contrib=jnp.zeros_like(origins),
    )


def _trace_bounce(scene, cfg, origin, direction, attenuation, radiance, seeds, depth, spec_last=None, pending=None):
    """One path segment for every lane: intersect, then closest-hit shade
    or miss.  Returns the post-trace payload (pre-Russian-roulette).

    With cfg.env_importance_sampling (beyond-reference; BASELINE.json
    north star) each surface hit additionally draws ONE env direction from
    the luminance alias table, traces a shadow ray, and adds the
    diffuse-lobe next-event contribution; env radiance on misses is then
    only credited to specular/primary segments (`spec_last` — the purpose
    the reference's dead `specular_bounce` payload flag was built for,
    optixSphere.h:44).  Requires rr_mode="standard" — enforced by
    RenderConfig validation: the reference estimator's terminal /p
    division would bias mid-path NEE contributions.

    Multi-queue NEE (`pending` is not None): the PREVIOUS segment's
    shadow ray rides this segment's closest-hit batch — 2x lanes, one
    kernel pass, one shared coherence sort — and its stored contribution
    is added here iff unoccluded (env light sits at infinity, so "any
    hit" == "closest hit exists").  This segment's shadow ray is returned
    as the new `pending` instead of being traced by a separate
    occluded_scene launch.  The reference analog is `traceOcclusion`
    (optixSphere.cu:134-156, dead code there) made batch-efficient.
    """
    nee = cfg.env_importance_sampling
    mq = pending is not None
    if mq:
        # Inactive pending lanes park far outside every AABB (origin
        # 3e37, +x): they fail slab tests / Möller-Trumbore cleanly and,
        # under the sorted kernels, share one sort key so they compact
        # into all-parked packets that do no triangle work.
        pact = pending["active"]
        park_o = jnp.zeros_like(origin).at[:, 0].set(3.0e37)
        park_d = jnp.zeros_like(direction).at[:, 0].set(1.0)
        o2 = jnp.where(pact[:, None], pending["origin"], park_o)
        d2 = jnp.where(pact[:, None], pending["dir"], park_d)
        hit_all = intersect_scene(
            scene,
            jnp.concatenate([origin, o2], axis=0),
            jnp.concatenate([direction, d2], axis=0),
            cfg.t_min, cfg.t_max, cfg,
        )
        n = origin.shape[0]
        hit = jax.tree.map(lambda x: x[:n], hit_all)
        shadow_blocked = hit_all.hit[n:]
        # Resolve the deferred contribution (additive; order vs this
        # segment's own env/emissive additions is immaterial).
        radiance = radiance + jnp.where(
            (pact & ~shadow_blocked)[:, None], pending["contrib"], 0.0
        )
    else:
        hit = intersect_scene(
            scene, origin, direction, cfg.t_min, cfg.t_max, cfg
        )

    # miss program (cu:531-567): radiance += att * env; done.  Hit lanes
    # never consume env_rad, so their gather rows collapse onto row 0.
    env_rad = eval_env(scene.env, direction, cfg, active=~hit.hit)
    if nee and cfg.nee_mis_spec:
        # spec_last carries the balance-heuristic MIS weight (f32):
        # 1.0 on primaries/glass, p_ggx/(p_ggx+p_light) on spec-sampled
        # continuations, 0.0 on diffuse-sampled ones.
        radiance_miss = radiance + attenuation * env_rad * spec_last[:, None]
    elif nee:
        radiance_miss = radiance + jnp.where(
            spec_last[:, None], attenuation * env_rad, 0.0
        )
    else:
        radiance_miss = radiance + attenuation * env_rad

    # NEE consumes extra _shade fields (normal, lobe data) that the packed
    # deferred path does not carry; it keeps the dense shade.  Prim ids
    # travel as exact f32 in the deferred pack, so scenes at >= 2^24
    # triangles also keep the dense shade (same guard as the sorted
    # intersect path, ClusterAccel._want_sort).
    if cfg.deferred_shade and not nee and scene.num_triangles < (1 << 24):
        sh = _shade_deferred(scene, cfg, hit, origin, direction, seeds, depth)
    else:
        sh = _shade(scene, cfg, hit, origin, direction, seeds, depth)
    seeds_out = sh["seeds"]

    hit_m = hit.hit
    radiance_hit = jnp.where(
        sh["emissive"][:, None],
        radiance + attenuation * sh["emission"],
        radiance,
    )

    if nee:
        from pathtracer.render.envmap import sample_env_alias

        if scene.env.alias_table is None:
            raise ValueError(
                "env_importance_sampling requires an alias table: build the "
                "environment with envmap.with_importance_sampling(env)"
            )
        seeds_out, u1, u2 = rng.uniform2(seeds_out)
        seeds_out, u3, u4 = rng.uniform2(seeds_out)
        env_dir, env_pdf_v, env_u, env_v = sample_env_alias(
            scene.env.alias_table, scene.env.height, scene.env.width,
            u1, u2, u3, u4,
        )
        if cfg.nee_defensive_mix:
            # Defensive one-sample mixture (config.py nee_defensive_mix):
            # draw the light direction from 0.5*alias + 0.5*cosine and
            # divide by the mixture density (balance heuristic).  u3/u4
            # are reused for the cosine draw — only one branch's value is
            # consumed per lane, selected by the independent u5.  u6 is
            # drawn and discarded to keep the seed chain in uniform2
            # pairs (oracle.py mirrors draw-for-draw).
            from pathtracer.render.envmap import (
                direction_to_uv,
                env_pdf_alias,
            )

            seeds_out, u5, _u6 = rng.uniform2(seeds_out)
            tang_n, binorm_n = vm.onb_from_normal(sh["normal"])
            dir_cos = vm.onb_transform(
                rng.cosine_sample_hemisphere(u3, u4),
                tang_n, sh["normal"], binorm_n,
            )
            take_alias = u5 < 0.5
            env_dir = jnp.where(take_alias[:, None], env_dir, dir_cos)
            u_cos, v_cos = direction_to_uv(dir_cos)
            env_u = jnp.where(take_alias, env_u, u_cos)
            env_v = jnp.where(take_alias, env_v, v_cos)
            p_alias = jnp.where(
                take_alias,
                env_pdf_v,
                env_pdf_alias(
                    scene.env.alias_table, scene.env.height,
                    scene.env.width, dir_cos,
                ),
            )
            cos_sel = jnp.maximum(vm.dot(sh["normal"], env_dir), 0.0)
            env_pdf_v = 0.5 * p_alias + 0.5 * cos_sel / jnp.pi
        from pathtracer.ops.intersect import occluded_scene

        cos_l = jnp.maximum(vm.dot(sh["normal"], env_dir), 0.0)
        cand = (
            hit_m
            & ~sh["done"]   # depth-truncated paths collect no env light in
            #                 the base estimator either (mean parity)
            & ~sh["glass"]
            & ~sh["emissive"]
            & ~sh["degenerate"]
            & (cos_l > 0.0)
        )
        if mq:
            # Occlusion resolves NEXT iteration, riding that segment's
            # closest-hit batch; no separate launch.
            nee_ok = cand
        else:
            occluded = occluded_scene(
                scene, sh["new_origin"], env_dir, cfg.t_min, cfg.t_max, cfg,
                active=cand,
            )
            nee_ok = cand & ~occluded
        l_env = eval_env(scene.env, env_dir, cfg, active=cand, uv=(env_u, env_v))
        # Lobe-partitioned estimator, consistent with the base integrator.
        # The base (non-NEE) estimator multiplies EVERY continuation by the
        # deterministic blend M = brdf_combined and the |n.l_spec| cosine
        # (IdotN quirk — reference cu:776, 800, 860) while choosing the
        # continuation direction spec w.p. P_s, cosine otherwise.  Its
        # direct-env expectation is therefore
        #   M*IdotN * (P_s*E_spec[L*vis] + (1-P_s)*E_cos[L*vis]).
        # Here the cosine component is estimated by light sampling instead:
        #   E_cos[L*vis] ~= L*vis*(cos_l/pi)/pdf_l       (alias-table draw)
        # and env radiance on misses is then credited only to spec-sampled
        # segments (`spec_last`) — together reproducing the SAME mean with
        # lower variance.  tests/test_envmap.py gates the mean-convergence;
        # oracle.py carries the identical formula.
        weight = (
            (1.0 - sh["spec_prob"])
            * sh["idotn"]
            * cos_l
            / (jnp.pi * jnp.maximum(env_pdf_v, 1e-12))
        )
        contrib = attenuation * sh["brdf_combined"] * weight[:, None] * l_env
        if cfg.nee_mis_spec:
            from pathtracer.render.envmap import env_pdf_alias

            # Light-arm spec term, riding the SAME draw and shadow ray.
            # The base estimator's spec-component integrand in direction
            # measure is g(d) = P_s*[P_s*f_spec(d) +
            # (1-P_s)*albedo*pi*p_ggx(d)]*|n.d|*L(d)*vis(d) (its M =
            # brdf_combined blend and IdotN quirk made explicit as
            # functions of d); the alias/mixture draw estimates it as
            # w_l * g(d_l)/p_light(d_l) with the balance weight
            # w_l = p_light/(p_light + p_ggx).  env_pdf_v IS p_light
            # here (the mixture overwrote it when defensive).
            view = -direction
            h_l = vm.normalize(view + env_dir)
            d_term_l = bsdf.d_ggx(sh["normal"], h_l, sh["alpha"])
            g_term_l = bsdf.g_smith(sh["alpha"], sh["normal"], view, env_dir)
            ndotv_l = vm.dot(sh["normal"], view)
            denom_l = 4.0 * jnp.abs(ndotv_l) * jnp.abs(
                vm.dot(sh["normal"], env_dir)
            )
            brdf_spec_l = sh["f_vec"] * (
                d_term_l * g_term_l / jnp.maximum(denom_l, 1e-10)
            )[:, None]
            ndoth_l = jnp.maximum(vm.dot(sh["normal"], h_l), 1e-10)
            vdoth_l = jnp.maximum(vm.dot(view, h_l), 1e-10)
            p_ggx_l = bsdf.ggx_pdf(d_term_l, ndoth_l, vdoth_l)
            w_l = env_pdf_v / jnp.maximum(env_pdf_v + p_ggx_l, 1e-20)
            g_spec = sh["spec_prob"][:, None] * (
                sh["spec_prob"][:, None] * brdf_spec_l
                + ((1.0 - sh["spec_prob"]) * jnp.pi * p_ggx_l)[:, None]
                * sh["diffuse_albedo"]
            ) * cos_l[:, None]
            contrib = contrib + (
                attenuation
                * g_spec
                * (w_l / jnp.maximum(env_pdf_v, 1e-12))[:, None]
                * l_env
            )
        if mq:
            pend_out = dict(
                active=cand,
                origin=sh["new_origin"],
                dir=env_dir,
                contrib=jnp.where(cand[:, None], contrib, 0.0),
            )
        else:
            radiance_hit = radiance_hit + jnp.where(
                nee_ok[:, None], contrib, 0.0
            )
        if cfg.nee_mis_spec:
            # BSDF-arm weight for the NEXT segment's env credit: p_light
            # and p_ggx evaluated at the spec continuation direction with
            # THIS bounce's normal (the same two densities as w_l above).
            p_alias_s = env_pdf_alias(
                scene.env.alias_table, scene.env.height, scene.env.width,
                sh["spec_dir"],
            )
            if cfg.nee_defensive_mix:
                cos_s = jnp.maximum(vm.dot(sh["normal"], sh["spec_dir"]), 0.0)
                p_light_s = 0.5 * p_alias_s + 0.5 * cos_s / jnp.pi
            else:
                p_light_s = p_alias_s
            w_b = sh["spec_pdf"] / jnp.maximum(
                sh["spec_pdf"] + p_light_s, 1e-20
            )
            spec_next = jnp.where(
                sh["glass"],
                jnp.float32(1.0),
                jnp.where(sh["choose_spec"], w_b, 0.0),
            )
        else:
            spec_next = sh["choose_spec"] | sh["glass"]
    else:
        spec_next = spec_last

    out = dict(
        radiance=jnp.where(hit_m[:, None], radiance_hit, radiance_miss),
        attenuation=jnp.where(
            (hit_m & sh["att_ok"])[:, None],
            attenuation * sh["att_factor"],
            attenuation,
        ),
        origin=jnp.where(hit_m[:, None], sh["new_origin"], origin),
        direction=jnp.where(hit_m[:, None], sh["new_direction"], direction),
        done=jnp.where(hit_m, sh["done"], True),  # miss always terminates
        seeds=jnp.where(hit_m, seeds_out, seeds),
        spec_last=spec_next,
        hit=hit_m,  # for shadow-ray accounting (segment counters)
    )
    if mq:
        out["pending"] = pend_out
    return out


def render_rays(
    scene: Scene,
    cfg: RenderConfig,
    origins: jnp.ndarray,     # [N,3]
    directions: jnp.ndarray,  # [N,3]
    seeds: jnp.ndarray,       # [N] u32
    return_stats: bool = False,
):
    """Trace a batch of primary rays to completion; returns radiance [N,3].

    return_stats=True additionally returns {"segments", "shadow_segments"}
    — the rays actually traced by THIS loop (bench accounting lives inside
    the render path, never in a duplicated loop)."""
    # State arrays derive from the inputs (*_like) so varying manual axes
    # stay consistent when this runs inside shard_map.
    state = dict(
        origin=origins,
        direction=directions,
        attenuation=jnp.ones_like(origins),
        radiance=jnp.zeros_like(origins),
        seeds=seeds,
        depth=jnp.full_like(seeds, cfg.max_depth, dtype=jnp.int32),
        terminated=jnp.zeros_like(seeds, dtype=bool),
        result=jnp.zeros_like(origins),
        spec_last=jnp.ones_like(
            seeds,
            dtype=jnp.float32 if cfg.nee_mis_spec else bool,
        ),  # primaries count specular
        bounce=jnp.int32(0),
        # + seeds[0]*0: ties the counters to per-device data so shard_map
        # varying-axes tracking sees them as device-varying like the rays.
        segments=jnp.int32(0) + seeds[0].astype(jnp.int32) * 0,
        shadow=jnp.int32(0) + seeds[0].astype(jnp.int32) * 0,
    )
    mq = nee_mq_on(cfg)
    if mq:
        state["pend"] = make_pending(origins)

    max_traces = cfg.max_depth + 2  # depth<=0 forces done; +1 safety
    if mq:
        # The final segment's deferred shadow still needs one resolving
        # trace; pend_active dies with advs, so one extra pass suffices.
        max_traces += 1

    def cond(st):
        live_any = ~jnp.all(st["terminated"])
        if mq:
            live_any = live_any | jnp.any(st["pend"]["active"])
        return live_any & (st["bounce"] < max_traces)

    def body(st):
        live = ~st["terminated"]

        tb = _trace_bounce(
            scene, cfg, st["origin"], st["direction"], st["attenuation"],
            st["radiance"], st["seeds"], st["depth"], st["spec_last"],
            pending=st["pend"] if mq else None,
        )
        att_new = tb["attenuation"]
        radiance_new = tb["radiance"]

        # -- Russian roulette (cu:379-387) --------------------------------
        seeds_new, u_rr = rng.uniform(tb["seeds"])
        p = jnp.max(att_new, axis=-1)
        rr_done = tb["done"] | (u_rr > p)

        newly = live & rr_done
        p_safe = jnp.where(p > 0.0, p, 1.0)
        # Survival probability is min(p, 1): when p > 1 the u_rr > p coin
        # can never fire, so dividing by the unclamped p loses energy
        # (textbook RR divides by the actual survival probability).
        p_div = jnp.minimum(p_safe, 1.0)
        if cfg.rr_mode == "reference":
            # path_rgb = radiance; on termination path_rgb /= p (cu:382-387).
            result_terminated = radiance_new / p_safe[:, None]
        else:
            # standard: unbiased — survivors divide attenuation by min(p,1).
            result_terminated = radiance_new
            att_new = jnp.where(
                (live & ~rr_done)[:, None], att_new / p_div[:, None], att_new
            )

        result = jnp.where(newly[:, None], result_terminated, st["result"])
        terminated = st["terminated"] | newly

        # -- masked state update (only surviving live lanes advance) ------
        advs = live & ~rr_done
        adv = advs[:, None]
        if mq:
            # Deferred-shadow estimator under RR: killed paths DROP the
            # pending contribution; survivors scale it by 1/p_survive.
            # E[1{survive}/p] = 1 keeps the NEE term unbiased (see
            # config.nee_multi_queue).
            pend_new = dict(
                active=tb["pending"]["active"] & advs,
                origin=tb["pending"]["origin"],
                dir=tb["pending"]["dir"],
                contrib=tb["pending"]["contrib"] / p_div[:, None],
            )
        st_new = dict(
            origin=jnp.where(adv, tb["origin"], st["origin"]),
            direction=jnp.where(adv, tb["direction"], st["direction"]),
            attenuation=jnp.where(adv, att_new, st["attenuation"]),
            radiance=jnp.where(adv, radiance_new, st["radiance"]),
            seeds=jnp.where(live, seeds_new, st["seeds"]),
            depth=jnp.where(advs, st["depth"] - 1, st["depth"]),
            terminated=terminated,
            result=result,
            spec_last=jnp.where(advs, tb["spec_last"], st["spec_last"]),
            bounce=st["bounce"] + 1,
            segments=st["segments"] + jnp.sum(live.astype(jnp.int32)),
            shadow=st["shadow"]
            + (
                # mq: shadow rays traced THIS iteration = incoming pending.
                jnp.sum(st["pend"]["active"].astype(jnp.int32))
                if mq
                else jnp.sum((live & tb["hit"]).astype(jnp.int32))
                if cfg.env_importance_sampling
                else jnp.int32(0)
            ),
        )
        if mq:
            st_new["pend"] = pend_new
        return st_new

    final = jax.lax.while_loop(cond, body, state)
    # Safety: lanes that somehow never terminated contribute their radiance.
    radiance = jnp.where(
        final["terminated"][:, None], final["result"], final["radiance"]
    )
    if return_stats:
        return radiance, dict(
            segments=final["segments"], shadow_segments=final["shadow"]
        )
    return radiance


@functools.partial(jax.jit, static_argnames=("cfg",))
def count_segments(
    scene: Scene,
    cam: dict,
    cfg: RenderConfig,
    subframe: jnp.ndarray,
) -> jnp.ndarray:
    """Total traced ray segments for one launch (Mrays/s accounting),
    INCLUDING NEE shadow rays — counted by the exact schedule that
    renders (render_frame_stats), not by a duplicated loop."""
    _, stats = render_frame_stats(scene, cam, cfg, subframe)
    return stats["segments"] + stats["shadow_segments"]


# ---------------------------------------------------------------------------
# Path regeneration ("persistent lanes")
# ---------------------------------------------------------------------------

def render_pixels_regen(
    scene: Scene,
    cam: dict,
    cfg: RenderConfig,
    pixel_ids: jnp.ndarray,   # [Np] i32
    subframe: jnp.ndarray,
    sample_offset: jnp.ndarray,
    spp: int,
    return_stats: bool = False,
):
    """One lane per pixel; each lane traces its spp samples *sequentially*,
    respawning a fresh camera ray the moment its current path terminates.

    This is the wavefront answer to lane divergence: with the reference's
    aggressive Russian roulette most paths die after 1-2 bounces, so the
    wide schedule (pixels x samples lanes, dead lanes masked) wastes ~85%
    of lane-iterations.  Regeneration keeps utilisation near 100% — every
    iteration every lane is tracing a real segment until its sample budget
    runs out.  Seeds are the same global (pixel, sample, subframe)
    counters as the wide path, so each sample's radiance is identical.
    """
    n = pixel_ids.shape[0]
    px = pixel_ids % cfg.width
    py = pixel_ids // cfg.width

    def make_path(sample_i):
        seeds0 = rng.make_seeds(pixel_ids, sample_offset + sample_i, subframe)
        return generate_camera_rays(cam, px, py, seeds0, cfg)

    o0, d0, s0 = make_path(jnp.zeros_like(pixel_ids))
    state = dict(
        origin=o0,
        direction=d0,
        seeds=s0,
        attenuation=jnp.ones_like(o0),
        radiance=jnp.zeros_like(o0),
        depth=jnp.full_like(pixel_ids, cfg.max_depth, dtype=jnp.int32),
        sample_i=jnp.zeros_like(pixel_ids),
        accum=jnp.zeros_like(o0),
        exhausted=jnp.zeros_like(pixel_ids, dtype=bool),
        spec_last=jnp.ones_like(
            pixel_ids,
            dtype=jnp.float32 if cfg.nee_mis_spec else bool,
        ),
        it=jnp.int32(0),
        segments=jnp.int32(0) + pixel_ids[0] * 0,   # shard_map-varying
        shadow=jnp.int32(0) + pixel_ids[0] * 0,
    )
    mq = nee_mq_on(cfg)
    if mq:
        state["pend"] = make_pending(o0)
    max_iters = spp * (cfg.max_depth + 2) + 4

    def cond(st):
        return (~jnp.all(st["exhausted"])) & (st["it"] < max_iters)

    def body(st):
        live = ~st["exhausted"]
        tb = _trace_bounce(
            scene, cfg, st["origin"], st["direction"], st["attenuation"],
            st["radiance"], st["seeds"], st["depth"], st["spec_last"],
            pending=st["pend"] if mq else None,
        )
        att_new = tb["attenuation"]
        radiance_new = tb["radiance"]

        seeds_new, u_rr = rng.uniform(tb["seeds"])
        p = jnp.max(att_new, axis=-1)
        rr_done = tb["done"] | (u_rr > p)
        newly = live & rr_done
        p_safe = jnp.where(p > 0.0, p, 1.0)
        p_div = jnp.minimum(p_safe, 1.0)  # survival prob is min(p,1)
        if cfg.rr_mode == "reference":
            result = radiance_new / p_safe[:, None]
        else:
            result = radiance_new
            att_new = jnp.where(
                (live & ~rr_done)[:, None], att_new / p_div[:, None], att_new
            )

        accum = st["accum"] + jnp.where(newly[:, None], result, 0.0)
        sample_i = st["sample_i"] + newly.astype(jnp.int32)
        exhausted = st["exhausted"] | (newly & (sample_i >= spp))

        # Respawn the next sample on lanes that just finished one.
        regen = newly & ~exhausted
        o_r, d_r, s_r = make_path(jnp.minimum(sample_i, spp - 1))
        adv = (live & ~rr_done)[:, None]
        rg = regen[:, None]

        if mq:  # see render_rays: drop on RR kill, scale survivors by 1/p
            pend_new = dict(
                active=tb["pending"]["active"] & (live & ~rr_done),
                origin=tb["pending"]["origin"],
                dir=tb["pending"]["dir"],
                contrib=tb["pending"]["contrib"] / p_div[:, None],
            )
        st_new = dict(
            origin=jnp.where(rg, o_r, jnp.where(adv, tb["origin"], st["origin"])),
            direction=jnp.where(rg, d_r, jnp.where(adv, tb["direction"], st["direction"])),
            seeds=jnp.where(regen, s_r, jnp.where(live, seeds_new, st["seeds"])),
            attenuation=jnp.where(rg, 1.0, jnp.where(adv, att_new, st["attenuation"])),
            radiance=jnp.where(rg, 0.0, jnp.where(adv, radiance_new, st["radiance"])),
            depth=jnp.where(
                regen,
                jnp.int32(cfg.max_depth),
                jnp.where(live & ~rr_done, st["depth"] - 1, st["depth"]),
            ),
            sample_i=sample_i,
            accum=accum,
            exhausted=exhausted,
            spec_last=jnp.where(
                regen,
                True,
                jnp.where(live & ~rr_done, tb["spec_last"], st["spec_last"]),
            ),
            it=st["it"] + 1,
            segments=st["segments"] + jnp.sum(live.astype(jnp.int32)),
            shadow=st["shadow"]
            + (
                jnp.sum(st["pend"]["active"].astype(jnp.int32))
                if mq
                else jnp.sum((live & tb["hit"]).astype(jnp.int32))
                if cfg.env_importance_sampling
                else jnp.int32(0)
            ),
        )
        if mq:
            st_new["pend"] = pend_new
        return st_new

    final = jax.lax.while_loop(cond, body, state)
    out = final["accum"] / jnp.float32(spp)
    if return_stats:
        return out, dict(
            iters=final["it"],
            segments=final["segments"],
            shadow_segments=final["shadow"],
        )
    return out


def resolve_stream_lanes(cfg: RenderConfig, n_pix: int) -> int:
    """cfg.stream_lanes, with 0 = auto: the nearest power of two to
    n_pix/16, clamped to [16384, 131072].

    The pool should scale with the frame: the work queue's drain tail
    costs roughly one pool of partially-idle iterations per frame, so an
    oversized pool on a small frame pays a tail it cannot amortise."""
    if cfg.stream_lanes:
        return cfg.stream_lanes
    target = max(1, n_pix // 16)
    lanes = 1 << max(0, target.bit_length() - 1)   # pow2 floor
    if target - lanes > 2 * lanes - target:        # round to NEAREST pow2
        lanes *= 2
    return min(131072, max(16384, lanes))


def _tiled_order(cfg: RenderConfig) -> bool:
    """Whether the stream renderer hands out pixels in 16x8 blocks.

    Consecutive lanes then cover a compact 2-D pixel block instead of a
    512-wide scanline strip, at the price of slot->pixel arithmetic and
    non-monotonic retire scatter rows.  An explicit option ("tiled") for
    experiments; "auto" = scanline.  Output is
    bitwise-identical either way: seeds key off the pixel id and each
    pixel's samples accumulate on one lane in sample order."""
    return cfg.pixel_order == "tiled"


def _tile_slot_to_pixel(slot: jnp.ndarray, width: int) -> jnp.ndarray:
    """Bijection [0, W*H) -> pixel id: consecutive 128-slot groups map to
    16x8 pixel blocks (blocks row-major).  Requires W%16==0, H%8==0."""
    b = slot // 128
    w = slot % 128
    by = w // 16
    bx = w - by * 16
    bpr = width // 16
    big_y = b // bpr
    big_x = b - big_y * bpr
    return (big_y * 8 + by) * width + big_x * 16 + bx


def render_pixels_stream(
    scene: Scene,
    cam: dict,
    cfg: RenderConfig,
    pixel_ids: jnp.ndarray | None,  # [Np] i32, or None = arange(W*H)
    subframe: jnp.ndarray,
    sample_offset: jnp.ndarray,
    spp: int,
    lanes: int,
    return_stats: bool = False,
):
    """Streaming work-queue renderer: a fixed pool of `lanes` persistent
    lanes consumes the whole pixel list.

    return_stats=True additionally returns {"iters", "segments",
    "shadow_segments"} — utilisation diagnostics and the exact traced-ray
    accounting used by bench.py / count_segments.

    Path regeneration alone still idles in the straggler tail — once a
    lane's pixel is finished it sits exhausted while the batch's deepest
    lane keeps looping (lane utilisation well under half at 10 spp).  Here a
    lane that finishes its pixel's sample budget scatter-adds the result
    and *pulls the next pixel* off a global queue implemented with a
    prefix sum (the JAX equivalent of the atomic work-queue counter in
    GPU persistent-threads renderers).  The tail is paid once per frame
    instead of once per tile, and tiling disappears entirely.

    Output matches the per-pixel schedules to 1 ulp: seeds are global
    (pixel, sample, subframe) counters and each pixel's samples
    accumulate in sample order on a single lane; the only op difference
    is the retire average's explicit reciprocal multiply (see comment at
    retire_rgb).
    """
    identity = pixel_ids is None  # frame render: slot maps to pixel id
    affine = isinstance(pixel_ids, tuple)  # (base, count) — see render_pixels
    if identity:
        n_pix = cfg.width * cfg.height
    elif affine:
        n_pix = pixel_ids[1]
    else:
        n_pix = pixel_ids.shape[0]
    lanes = min(lanes, n_pix)
    tiled = identity and _tiled_order(cfg)

    def slot_to_pixel(slot):
        if identity:
            if tiled:
                return _tile_slot_to_pixel(slot, cfg.width)
            return slot
        if affine:  # arithmetic, not a gather — the whole point
            return pixel_ids[0] + slot
        return pixel_ids[jnp.minimum(slot, n_pix - 1)]

    def make_path(pix, sample_i):
        seeds0 = rng.make_seeds(pix, sample_offset + sample_i, subframe)
        return generate_camera_rays(
            cam, pix % cfg.width, pix // cfg.width, seeds0, cfg
        )

    slot0 = jnp.arange(lanes, dtype=jnp.int32)       # position in pixel_ids
    if affine:
        # Tie to the device-varying base scalar so shard_map varying-axes
        # tracking sees the whole carry as device-varying.
        slot0 = slot0 + 0 * pixel_ids[0]
    elif not identity:
        # Tie to the sharded input so shard_map varying-axes tracking sees
        # the whole carry as device-varying.
        slot0 = slot0 + 0 * pixel_ids[:lanes]
    pix0 = slot_to_pixel(slot0)
    vary = pix0[0] * 0  # varying zero scalar (i32)
    o0, d0, s0 = make_path(pix0, jnp.zeros_like(pix0))

    # Retired pixels are staged in a tiny per-lane FIFO and flushed to the
    # output image every FLUSH_EVERY iterations (or when any lane's FIFO
    # fills), so the scatter into the [n_pix+1,3] image runs once per
    # flush instead of once per iteration.  A pixel occupies a lane for
    # >= spp * ~1.4 iterations, so a few staged retires per lane almost
    # never force an early flush.  Grouping is bitwise-neutral: each pixel
    # row receives exactly one non-zero add per frame either way.
    FIFO_D = cfg.fifo_depth
    FLUSH_EVERY = cfg.flush_every

    state = dict(
        slot=slot0,                                   # n_pix = retired lane
        pix=pix0,
        origin=o0,
        direction=d0,
        seeds=s0,
        attenuation=jnp.ones_like(o0),
        radiance=jnp.zeros_like(o0),
        depth=jnp.full_like(pix0, cfg.max_depth, dtype=jnp.int32),
        sample_i=jnp.zeros_like(pix0),
        lane_accum=jnp.zeros_like(o0),
        out=jnp.zeros((n_pix + 1, 3), jnp.float32)
        + vary.astype(jnp.float32),                   # +1 row = retired sink
        pend_slot=jnp.full((lanes, FIFO_D), n_pix, jnp.int32) + vary,
        pend_rgb=jnp.zeros((lanes, FIFO_D, 3), jnp.float32)
        + vary.astype(jnp.float32),
        pend_cnt=jnp.zeros_like(pix0),
        head=jnp.int32(lanes) + vary,
        spec_last=jnp.ones_like(
            pix0,
            dtype=jnp.float32 if cfg.nee_mis_spec else bool,
        ),
        it=jnp.int32(0),
        segments=jnp.int32(0) + vary,               # shard_map-varying
        shadow=jnp.int32(0) + vary,
    )
    mq = nee_mq_on(cfg)
    if mq:
        state["pend"] = make_pending(o0)
    max_iters = (n_pix * spp * (cfg.max_depth + 2)) // lanes + cfg.max_depth + 16

    def cond(st):
        return jnp.any(st["slot"] < n_pix) & (st["it"] < max_iters)

    def body(st):
        live = st["slot"] < n_pix
        tb = _trace_bounce(
            scene, cfg, st["origin"], st["direction"], st["attenuation"],
            st["radiance"], st["seeds"], st["depth"], st["spec_last"],
            pending=st["pend"] if mq else None,
        )
        seeds_new, u_rr = rng.uniform(tb["seeds"])
        p = jnp.max(tb["attenuation"], axis=-1)
        rr_done = tb["done"] | (u_rr > p)
        newly = live & rr_done
        p_safe = jnp.where(p > 0.0, p, 1.0)
        p_div = jnp.minimum(p_safe, 1.0)  # survival prob is min(p,1)
        if cfg.rr_mode == "reference":
            result = tb["radiance"] / p_safe[:, None]
        else:
            result = tb["radiance"]
            tb["attenuation"] = jnp.where(
                (live & ~rr_done)[:, None],
                tb["attenuation"] / p_div[:, None],
                tb["attenuation"],
            )

        lane_accum = st["lane_accum"] + jnp.where(newly[:, None], result, 0.0)
        sample_i = st["sample_i"] + newly.astype(jnp.int32)
        pixel_done = newly & (sample_i >= spp)

        # -- retire finished pixels into the per-lane FIFO ----------------
        # Output rows are pixel ids in identity mode (slot==pixel unless
        # tiled, where pix = _tile_slot_to_pixel(slot)) and list positions
        # otherwise.
        retire_row = st["pix"] if tiled else st["slot"]
        retire_slot = jnp.where(pixel_done, retire_row, n_pix)
        # Explicit reciprocal multiply (not /spp): compilers may or may
        # not rewrite a divide-by-constant into a reciprocal multiply,
        # while a single mul is deterministic across backends.
        retire_rgb = jnp.where(
            pixel_done[:, None], lane_accum * jnp.float32(1.0 / spp), 0.0
        )
        pend_slot, pend_rgb = st["pend_slot"], st["pend_rgb"]
        for fpos in range(FIFO_D):
            sel = pixel_done & (st["pend_cnt"] == fpos)
            pend_slot = pend_slot.at[:, fpos].set(
                jnp.where(sel, retire_slot, pend_slot[:, fpos])
            )
            pend_rgb = pend_rgb.at[:, fpos].set(
                jnp.where(sel[:, None], retire_rgb, pend_rgb[:, fpos])
            )
        pend_cnt = st["pend_cnt"] + pixel_done.astype(jnp.int32)

        # -- periodic flush: one batched scatter --------------------------
        do_flush = (st["it"] % FLUSH_EVERY == FLUSH_EVERY - 1) | jnp.any(
            pend_cnt >= FIFO_D
        )

        def flush(args):
            out, ps, pr = args
            out = out.at[ps.reshape(-1)].add(pr.reshape(-1, 3))
            return (
                out,
                jnp.full_like(ps, n_pix),
                jnp.zeros_like(pr),
                jnp.zeros_like(pend_cnt),
            )

        def no_flush(args):
            out, ps, pr = args
            return (out, ps, pr, pend_cnt)

        out, pend_slot, pend_rgb, pend_cnt = jax.lax.cond(
            do_flush, flush, no_flush, (st["out"], pend_slot, pend_rgb)
        )

        # -- work queue: pull the next pixel via prefix sum --------------
        inc = jnp.cumsum(pixel_done.astype(jnp.int32))
        new_slot = jnp.where(pixel_done, st["head"] + inc - 1, st["slot"])
        head = st["head"] + inc[-1]
        live_next = new_slot < n_pix
        pix = jnp.where(pixel_done, slot_to_pixel(new_slot), st["pix"])
        sample_i = jnp.where(pixel_done, 0, sample_i)
        lane_accum = jnp.where(pixel_done[:, None], 0.0, lane_accum)

        # -- respawn: next sample (same or freshly pulled pixel) ---------
        regen = (newly & live_next) | (pixel_done & live_next)
        o_r, d_r, s_r = make_path(pix, jnp.minimum(sample_i, spp - 1))
        adv = (live & ~rr_done)[:, None]
        rg = regen[:, None]

        if mq:  # see render_rays: drop on RR kill, scale survivors by 1/p
            pend_new = dict(
                active=tb["pending"]["active"] & (live & ~rr_done),
                origin=tb["pending"]["origin"],
                dir=tb["pending"]["dir"],
                contrib=tb["pending"]["contrib"] / p_div[:, None],
            )
        st_new = dict(
            slot=new_slot,
            pix=pix,
            origin=jnp.where(rg, o_r, jnp.where(adv, tb["origin"], st["origin"])),
            direction=jnp.where(rg, d_r, jnp.where(adv, tb["direction"], st["direction"])),
            seeds=jnp.where(regen, s_r, jnp.where(live, seeds_new, st["seeds"])),
            attenuation=jnp.where(rg, 1.0, jnp.where(adv, tb["attenuation"], st["attenuation"])),
            radiance=jnp.where(rg, 0.0, jnp.where(adv, tb["radiance"], st["radiance"])),
            depth=jnp.where(
                regen,
                jnp.int32(cfg.max_depth),
                jnp.where(live & ~rr_done, st["depth"] - 1, st["depth"]),
            ),
            sample_i=sample_i,
            lane_accum=lane_accum,
            out=out,
            pend_slot=pend_slot,
            pend_rgb=pend_rgb,
            pend_cnt=pend_cnt,
            head=head,
            spec_last=jnp.where(
                regen, True,
                jnp.where(live & ~rr_done, tb["spec_last"], st["spec_last"]),
            ),
            it=st["it"] + 1,
            segments=st["segments"] + jnp.sum(live.astype(jnp.int32)),
            shadow=st["shadow"]
            + (
                jnp.sum(st["pend"]["active"].astype(jnp.int32))
                if mq
                else jnp.sum((live & tb["hit"]).astype(jnp.int32))
                if cfg.env_importance_sampling
                else jnp.int32(0)
            ),
        )
        if mq:
            st_new["pend"] = pend_new
        return st_new

    final = jax.lax.while_loop(cond, body, state)
    # Final flush: scatter any retires still staged in the FIFOs.
    out = final["out"].at[final["pend_slot"].reshape(-1)].add(
        final["pend_rgb"].reshape(-1, 3)
    )
    if return_stats:
        return out[:n_pix], dict(
            iters=final["it"],
            segments=final["segments"],
            shadow_segments=final["shadow"],
        )
    return out[:n_pix]


# ---------------------------------------------------------------------------
# Frame rendering
# ---------------------------------------------------------------------------

def render_pixels(
    scene: Scene,
    cam: dict,
    cfg: RenderConfig,
    pixel_ids: jnp.ndarray | None,  # [Np] i32 flat ids, None = whole frame
    subframe: jnp.ndarray,    # scalar i32
    sample_offset: jnp.ndarray | int = 0,  # first global sample index
    spp: int | None = None,   # samples per pixel this launch
    return_stats: bool = False,
):
    """Render one batch of samples for each pixel; returns the
    sample-averaged radiance [Np,3] (the reference's `payload_rgb /
    sample_batch_count`, cu:397-401).

    Sample-sharded multi-chip rendering passes each device its own global
    sample_offset slice, so seeds — and therefore radiance values — are
    identical to an unsharded run (BASELINE.md reproducibility).

    return_stats=True additionally returns {"segments", "shadow_segments"}
    counted by whichever schedule runs."""
    if spp is None:
        spp = cfg.samples_per_launch
    sample_offset = jnp.asarray(sample_offset, dtype=jnp.int32)
    # `pixel_ids` may be an AFFINE range (base_i32_scalar, count): the
    # contiguous slice `base + arange(count)`.  Sharded pixel rendering
    # passes this instead of a materialized id array so the streaming
    # schedule's slot->pixel map stays ARITHMETIC instead of a
    # per-iteration [lanes]-row gather from a 2M-entry id table.
    affine = isinstance(pixel_ids, tuple)
    if pixel_ids is None:
        n_pix = cfg.width * cfg.height
    elif affine:
        n_pix = pixel_ids[1]
    else:
        n_pix = pixel_ids.shape[0]

    if cfg.regenerate and spp > 1:
        lanes = resolve_stream_lanes(cfg, n_pix)
        if n_pix > lanes:
            return render_pixels_stream(
                scene, cam, cfg, pixel_ids, subframe, sample_offset, spp,
                lanes, return_stats=return_stats,
            )
        if pixel_ids is None:
            pixel_ids = jnp.arange(n_pix, dtype=jnp.int32)
        elif affine:
            pixel_ids = pixel_ids[0] + jnp.arange(n_pix, dtype=jnp.int32)
        return render_pixels_regen(
            scene, cam, cfg, pixel_ids, subframe, sample_offset, spp,
            return_stats=return_stats,
        )
    if pixel_ids is None:
        pixel_ids = jnp.arange(n_pix, dtype=jnp.int32)
    elif affine:
        pixel_ids = pixel_ids[0] + jnp.arange(n_pix, dtype=jnp.int32)

    np_ = pixel_ids.shape[0]
    pixel_rep = jnp.repeat(pixel_ids, spp)                    # [Np*spp]
    sample_rep = sample_offset + jnp.tile(
        jnp.arange(spp, dtype=jnp.int32), np_
    )
    seeds = rng.make_seeds(pixel_rep, sample_rep, subframe)

    px = pixel_rep % cfg.width
    py = pixel_rep // cfg.width

    origins, directions, seeds = generate_camera_rays(cam, px, py, seeds, cfg)
    if return_stats:
        radiance, stats = render_rays(
            scene, cfg, origins, directions, seeds, return_stats=True
        )
        return jnp.mean(radiance.reshape(np_, spp, 3), axis=1), stats
    radiance = render_rays(scene, cfg, origins, directions, seeds)
    return jnp.mean(radiance.reshape(np_, spp, 3), axis=1)


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_frame(
    scene: Scene,
    cam: dict,
    cfg: RenderConfig,
    subframe: jnp.ndarray,
) -> jnp.ndarray:
    """One full launch: radiance image [H,W,3] (pre-accumulation)."""
    n_pix = cfg.width * cfg.height
    if cfg.tile_pixels and cfg.tile_pixels < n_pix:
        tile = cfg.tile_pixels
        if n_pix % tile != 0:
            raise ValueError("tile_pixels must divide width*height")
        tiles = n_pix // tile
        ids = jnp.arange(n_pix, dtype=jnp.int32).reshape(tiles, tile)

        def body(_, pix):
            return None, render_pixels(scene, cam, cfg, pix, subframe)

        _, out = jax.lax.scan(body, None, ids)
        img = out.reshape(n_pix, 3)
    else:
        # None = identity pixel mapping: the streaming renderer then skips
        # the per-iteration pixel-id gather.
        img = render_pixels(scene, cam, cfg, None, subframe)
    return img.reshape(cfg.height, cfg.width, 3)


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_frame_stats(
    scene: Scene,
    cam: dict,
    cfg: RenderConfig,
    subframe: jnp.ndarray,
):
    """render_frame + exact traced-ray accounting: returns
    (image [H,W,3], {"segments", "shadow_segments"}) counted inside the
    schedule that actually renders (incl. NEE shadow rays), plus "iters"
    (bounce-loop iterations) from the untiled regenerating schedules."""
    n_pix = cfg.width * cfg.height
    if cfg.tile_pixels and cfg.tile_pixels < n_pix:
        tile = cfg.tile_pixels
        if n_pix % tile != 0:
            raise ValueError("tile_pixels must divide width*height")
        tiles = n_pix // tile
        ids = jnp.arange(n_pix, dtype=jnp.int32).reshape(tiles, tile)

        def body(tot, pix):
            out, stats = render_pixels(
                scene, cam, cfg, pix, subframe, return_stats=True
            )
            return (
                tot[0] + stats["segments"],
                tot[1] + stats["shadow_segments"],
            ), out

        (segs, shadow), out = jax.lax.scan(
            body, (jnp.int32(0), jnp.int32(0)), ids
        )
        img = out.reshape(n_pix, 3)
        stats = dict(segments=segs, shadow_segments=shadow)
    else:
        img, stats = render_pixels(
            scene, cam, cfg, None, subframe, return_stats=True
        )
    return img.reshape(cfg.height, cfg.width, 3), stats


def camera_arrays(camera, cfg: RenderConfig) -> dict:
    """Host camera -> device UVW dict for render_frame."""
    cam = camera.with_aspect(cfg.width, cfg.height)
    u, v, w = cam.uvw_frame()
    return {
        "eye": jnp.asarray(cam.eye_np()),
        "U": jnp.asarray(u),
        "V": jnp.asarray(v),
        "W": jnp.asarray(w),
    }
