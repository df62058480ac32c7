"""AOV (arbitrary output variable) G-buffer pass and edge-avoiding
denoiser — beyond-reference production features.

The reference renderer outputs only the beauty pass (its display buffer,
optixSphere.cu:435).  Production path tracers additionally expose
per-pixel geometry buffers (normal / depth / albedo / material id) for
compositing and denoising; this module renders them with ONE
deterministic center ray per pixel (no jitter, no DOF — the buffers are
noise-free by construction) and implements the classic edge-avoiding
A-Trous wavelet filter (Dammertz et al. 2010) guided by them.

The denoiser makes 1-spp interactive previews usable: the viewer's
adaptive preview path can trade its resolution-vs-noise dial for a
filtered full-resolution image.  It runs on the LINEAR accumulated radiance before the film chain
(exposure/tonemap/gamma), so the post pipeline is untouched and
`denoise="off"` keeps every golden bitwise-identical.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pathtracer.config import RenderConfig
from pathtracer.ops.intersect import intersect_scene
from pathtracer.scene.scene import Scene
from pathtracer.utils import math as vm


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_aov(scene: Scene, cam: dict, cfg: RenderConfig):
    """G-buffer at pixel centers: dict of [H,W,...] arrays.

    Returns {"normal": [H,W,3] smooth shading normal (no normal map —
    guidance wants geometry, not texture detail), "depth": [H,W] hit
    distance (0 where miss), "albedo": [H,W,3] base color (texture
    sample or material diffuse; env radiance where miss), "mat": [H,W]
    i32 material id (-1 where miss), "hit": [H,W] bool}.

    Conventions mirror the closest-hit program (integrator._shade,
    reference optixSphere.cu:616-717): barycentric smooth normal with
    flat-normal fallback for backfacing/degenerate cases (cu:664-675),
    UV v-flip (cu:659).  Deterministic: center rays, no RNG draws.
    """
    from pathtracer.render.envmap import eval_env
    from pathtracer.scene import scene as S

    n_pix = cfg.width * cfg.height
    pix = jnp.arange(n_pix, dtype=jnp.int32)
    px = (pix % cfg.width).astype(jnp.float32)
    py = (pix // cfg.width).astype(jnp.float32)

    # Center rays: the raygen NDC map (integrator.generate_camera_rays,
    # cu:328-335) with jitter fixed at 0.5 and no DOF.
    dx = 2.0 * (px + 0.5) / jnp.float32(cfg.width) - 1.0
    dy = 2.0 * (py + 0.5) / jnp.float32(cfg.height) - 1.0
    target = dx[:, None] * cam["U"] + dy[:, None] * cam["V"] + cam["W"]
    directions = vm.normalize(target)
    origins = jnp.broadcast_to(cam["eye"], directions.shape) + 0.0 * directions

    hit = intersect_scene(scene, origins, directions, cfg.t_min, cfg.t_max, cfg)

    prim = jnp.maximum(hit.prim, 0)
    ta = scene.tri_attrs[prim]
    tri_v = ta[:, S.TRI_V].reshape(-1, 3, 3)
    tri_n = ta[:, S.TRI_N].reshape(-1, 3, 3)
    tri_uv = ta[:, S.TRI_UV].reshape(-1, 3, 2)
    mat = ta[:, S.TRI_MAT].astype(jnp.int32)
    m = scene.materials
    ma = m.attrs[mat]

    v0, v1, v2 = tri_v[:, 0], tri_v[:, 1], tri_v[:, 2]
    flat_n = vm.normalize(jnp.cross(v1 - v0, v2 - v0))
    flat_n = vm.faceforward(flat_n, -directions, flat_n)

    beta = hit.bary[:, 0]
    gamma = hit.bary[:, 1]
    w_interp = jnp.stack([1.0 - beta - gamma, beta, gamma], axis=-1)
    uv = vm.interp3(w_interp, tri_uv)
    tex_u = uv[:, 0]
    tex_v = (1.0 - uv[:, 1]) if cfg.flip_v else uv[:, 1]

    normal = vm.normalize(vm.interp3(w_interp, tri_n))
    normal = jnp.where(
        (vm.dot(normal, directions) > 0.0)[:, None], flat_n, normal
    )

    # Base-color albedo: texture sample where mapped, material diffuse
    # otherwise (the _shade prop(0, ...) path without the mip ladder).
    has_alb = ma[:, S.MAT_HAS_MAP][:, 0] > 0.5
    if m.bundled:
        from pathtracer.render.texsample import sample_bundle

        samples = sample_bundle(
            m.texture_bundles,
            ma[:, S.MAT_BUNDLE_OFFSET].astype(jnp.int32),
            ma[:, S.MAT_BUNDLE_WIDTH].astype(jnp.int32),
            ma[:, S.MAT_BUNDLE_HEIGHT].astype(jnp.int32),
            tex_u, tex_v,
            morton=m.bundled_morton,
            scrambled=m.bundled_scrambled,
            pow2_dims=m.bundled_pow2_dims,
            active=hit.hit & has_alb,
        )
        tex_albedo = samples[0]
    else:
        from pathtracer.render.texsample import material_property

        tex_albedo = material_property(
            m.texture_quads,
            has_alb,
            ma[:, S.MAT_MAP_OFFSET][:, 0].astype(jnp.int32),
            ma[:, S.MAT_MAP_WIDTH][:, 0].astype(jnp.int32),
            ma[:, S.MAT_MAP_HEIGHT][:, 0].astype(jnp.int32),
            ma[:, S.MAT_DIFFUSE],
            tex_u, tex_v,
        )
    albedo = jnp.where(has_alb[:, None], tex_albedo, ma[:, S.MAT_DIFFUSE])
    # Miss lanes: environment radiance as "albedo" (what the pixel shows).
    env_rad = eval_env(scene.env, directions, cfg, active=~hit.hit)
    albedo = jnp.where(hit.hit[:, None], albedo, env_rad)

    hm = hit.hit
    shape = (cfg.height, cfg.width)
    return {
        "normal": jnp.where(hm[:, None], normal, 0.0).reshape(*shape, 3),
        "depth": jnp.where(hm, hit.t, 0.0).reshape(shape),
        "albedo": albedo.reshape(*shape, 3),
        "mat": jnp.where(hm, mat, -1).reshape(shape),
        "hit": hm.reshape(shape),
    }


def defocus_mask(aov: dict, cfg: RenderConfig):
    """[H,W] defocus weight in [0,1] from the thin-lens circle of
    confusion, or None when DOF is off.

    The G-buffer is rendered PINHOLE (sharp), but with cfg.dof the
    accumulated radiance is defocus-blurred: in out-of-focus regions the
    sharp AOV normal/depth edges don't align with the blurred radiance,
    so bilateral guidance there preserves bokeh noise and halos around
    silhouettes.  This mask relaxes the
    geometry guidance where the CoC is large: 0 = in focus (full
    guidance), 1 = CoC spans several pixels (pure spatial smoothing +
    color weight).  CoC angular radius ~ A*|t-f|/t (thin lens,
    cu:279-294 parameters); the height factor converts to an approximate
    pixel count and saturates around a handful of pixels."""
    if not cfg.dof or cfg.dof_blurriness <= 0.0:
        return None
    t = aov["depth"]
    coc_px = (
        cfg.dof_blurriness
        * jnp.abs(t - cfg.focus_distance)
        / jnp.maximum(t, 1e-6)
        * (cfg.height / 4.0)
    )
    return jnp.where(aov["hit"], jnp.clip(coc_px, 0.0, 1.0), 0.0)


def _shift2d(x: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Edge-clamped spatial shift of [H,W,...] by (dy, dx)."""
    h, w = x.shape[0], x.shape[1]
    pad = [(max(dy, 0), max(-dy, 0)), (max(dx, 0), max(-dx, 0))] + [
        (0, 0)
    ] * (x.ndim - 2)
    xp = jnp.pad(x, pad, mode="edge")
    return jax.lax.dynamic_slice_in_dim(
        jax.lax.dynamic_slice_in_dim(xp, max(-dy, 0), h, axis=0),
        max(-dx, 0), w, axis=1,
    )


# B3-spline 5-tap weights of the A-Trous kernel (Dammertz et al. 2010).
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


@functools.partial(
    jax.jit,
    static_argnames=(
        "iterations", "sigma_color", "sigma_normal", "sigma_depth",
        "firefly_clamp",
    ),
)
def atrous_denoise(
    radiance: jnp.ndarray,   # [H,W,3] linear
    aov: dict,               # render_aov output (normal/depth/albedo/hit)
    defocus=None,            # [H,W] in [0,1] (defocus_mask) or None
    iterations: int = 4,
    sigma_color: float = 4.0,
    sigma_normal: float = 0.25,
    sigma_depth: float = 0.02,
    firefly_clamp: float = 4.0,
):
    """Edge-avoiding A-Trous wavelet denoise of linear radiance.

    Each iteration convolves with a 5x5 B3-spline kernel dilated by 2^i,
    with per-tap bilateral weights from the G-buffer (SVGF-style
    variance-adaptive luminance weight; sigma_color is in units of the
    local 3x3 luminance std):
      w = kernel * exp(-|l_p-l_q| / (sc * std3x3(l)_p + eps))
                 * max(0, n_p.n_q)^(1/sn)
                 * exp(-|z_p-z_q|^2 / sz^2)        [z normalised]
    Hit/miss boundaries never mix (hard mask), so the environment stays
    untouched.  Demodulating by albedo before filtering and remodulating
    after preserves texture detail (the standard SVGF trick).

    firefly_clamp > 0 first replaces hit pixels whose demodulated value
    exceeds `firefly_clamp` x the mean of their 8 neighbours with that
    mean: isolated high-energy outliers otherwise survive the bilateral
    color weight (they look like edges to it) and smear into disks.
    """
    normal = aov["normal"]
    depth = aov["depth"]
    albedo = aov["albedo"]
    hitm = aov["hit"].astype(jnp.float32)

    # Demodulate texture detail out of the signal (guard tiny albedo).
    alb_safe = jnp.maximum(albedo, 0.02)
    img = jnp.where(aov["hit"][..., None], radiance / alb_safe, radiance)

    depth_scale = jnp.maximum(jnp.max(depth), 1e-6)
    z = depth / depth_scale

    if firefly_clamp > 0:
        # Neighbourhood mean over HIT pixels only: at silhouettes the
        # raw 8-neighbour mean would blend (un-demodulated) environment
        # radiance into the replacement value.
        nsum = jnp.zeros_like(img)
        ncnt = jnp.zeros(img.shape[:2], img.dtype)
        for ky in (-1, 0, 1):
            for kx in (-1, 0, 1):
                if ky or kx:
                    nsum = nsum + _shift2d(img * hitm[..., None], ky, kx)
                    ncnt = ncnt + _shift2d(hitm, ky, kx)
        nmean = nsum / jnp.maximum(ncnt, 1.0)[..., None]
        spike = (jnp.max(img, axis=-1) > firefly_clamp * (
            jnp.max(nmean, axis=-1) + 1e-3
        )) & (ncnt > 0)
        img = jnp.where(
            (spike & aov["hit"])[..., None], nmean, img
        )

    for i in range(iterations):
        step = 1 << i
        # SVGF-style variance-adaptive luminance weight: the reference-RR
        # estimator's terminal /p division makes WHOLE REGIONS spiky (not
        # isolated outliers), and a fixed color sigma reads that noise as
        # edges.  Estimate per-pixel luminance std from the current 3x3
        # neighbourhood each iteration; noisy regions then smooth
        # aggressively while converged regions keep their true edges.
        lum = vm.luminance(img)
        mu = jnp.zeros_like(lum)
        mu2 = jnp.zeros_like(lum)
        for ky in (-1, 0, 1):
            for kx in (-1, 0, 1):
                lq = _shift2d(lum, ky, kx)
                mu = mu + lq
                mu2 = mu2 + lq * lq
        mu = mu / 9.0
        sdev = jnp.sqrt(jnp.maximum(mu2 / 9.0 - mu * mu, 0.0))

        acc = jnp.zeros_like(img)
        wsum = jnp.zeros(img.shape[:2], img.dtype)
        for ky in range(-2, 3):
            for kx in range(-2, 3):
                k = _B3[ky + 2] * _B3[kx + 2]
                dy, dx = ky * step, kx * step
                cq = _shift2d(img, dy, dx)
                nq = _shift2d(normal, dy, dx)
                zq = _shift2d(z, dy, dx)
                hq = _shift2d(hitm, dy, dx)
                lq = _shift2d(lum, dy, dx)
                wc = jnp.exp(
                    -jnp.abs(lum - lq) / (sigma_color * sdev + 1e-3)
                )
                wn = jnp.maximum(jnp.sum(normal * nq, axis=-1), 0.0) ** (
                    1.0 / sigma_normal
                )
                wz = jnp.exp(-((z - zq) ** 2) / (sigma_depth**2))
                g = wn * wz
                if defocus is not None:
                    # Defocused regions: the pinhole G-buffer's sharp
                    # edges don't align with the blurred radiance — fade
                    # geometry guidance toward pure spatial smoothing
                    # (color weight still applies; it follows the blurred
                    # signal itself).  See defocus_mask.
                    g = g + defocus * (1.0 - g)
                # Hit pixels only average hit pixels (and vice versa).
                same = 1.0 - jnp.abs(hitm - hq)
                w = k * wc * g * same
                acc = acc + w[..., None] * cq
                wsum = wsum + w
        img = acc / jnp.maximum(wsum, 1e-10)[..., None]

    out = jnp.where(aov["hit"][..., None], img * alb_safe, radiance)
    return out
