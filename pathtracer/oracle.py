"""Pure-numpy scalar reference renderer — the cross-validation oracle.

SURVEY.md §4 tier 3 calls for "a CPU reference renderer (same algorithms
in pure numpy)" to cross-validate the vectorized JAX integrator.  This
module re-implements the *exact* per-lane algorithm — same PCG draw
order (including draws the vectorized code computes for every lane and
then mask-discards), same estimator, same texture quantisation — as
straightforward scalar Python/numpy.

It is deliberately slow (a few hundred paths/second) and used only by
tests on tiny images.  Agreement is near-bitwise: float32 rounding can
differ (XLA fuses FMAs), which occasionally flips a discrete decision
(Russian-roulette coin, lobe choice) and decorrelates that lane — tests
therefore gate on the fraction of matching pixels rather than allclose.

Scope: brute-force intersection, constant/sunsky/equirect env, full
material model (textures, normal maps, GGX+diffuse, glass, emissive),
reference and standard RR modes, pinhole or thin-lens camera, and
next-event estimation (env_importance_sampling) with the same alias-table
draws, shadow query and lobe-partitioned weight as the integrator.
"""

from __future__ import annotations

import numpy as np

from pathtracer.scene import scene as S

F = np.float32
U = np.uint32


# ---------------------------------------------------------------------------
# RNG (utils/rng.py, scalar)
# ---------------------------------------------------------------------------

def pcg_hash(x: int) -> int:
    # uint32 wraparound is the algorithm; silence numpy's overflow warnings.
    with np.errstate(over="ignore"):
        x = U(x & 0xFFFFFFFF)
        state = U(x * U(747796405) + U(2891336453))
        word = U(((state >> U((state >> U(28)) + U(4))) ^ state) * U(277803737))
        return int((word >> U(22)) ^ word)


def make_seed(pixel: int, sample: int, subframe: int) -> int:
    h = pcg_hash(pixel ^ 0x9E3779B9)
    h = pcg_hash((h + sample * 0x85EBCA6B) & 0xFFFFFFFF)
    h = pcg_hash((h + subframe * 0xC2B2AE35) & 0xFFFFFFFF)
    return h | 1


def uniform(seed: int):
    seed = pcg_hash(seed)
    return seed, F(seed) * F(2.3283064365386963e-10)


def random_in_unit_sphere(seed: int):
    while True:
        seed, u1 = uniform(seed)
        seed, u2 = uniform(seed)
        seed, u3 = uniform(seed)
        p = F(2.0) * np.array([u1, u2, u3], F) - F(1.0)
        if float(p @ p) < 1.0:
            return seed, p


# ---------------------------------------------------------------------------
# math helpers (utils/math.py, scalar)
# ---------------------------------------------------------------------------

def normalize(v):
    n2 = F(v @ v)
    return (v * F(1.0 / np.sqrt(max(n2, 1e-20)))).astype(F)


def onb(normal):
    n = normalize(normal)
    up = np.array([0, 1, 0], F) if abs(n[1]) < 0.9999 else np.array([1, 0, 0], F)
    t = normalize(np.cross(up, n))
    b = normalize(np.cross(n, t))
    return t, b


def onb_transform(local, t, n, b):
    return (local[0] * t + local[1] * n + local[2] * b).astype(F)


def reflect(i, n):
    return (i - F(2.0) * F(i @ n) * n).astype(F)


def refract_sutil(i, n, eta_passed):
    eta = F(1.0 / eta_passed)
    cos_i = F(-(i @ n))
    k = F(1.0) - eta * eta * (F(1.0) - cos_i * cos_i)
    if k < 0:
        return np.zeros(3, F), True
    r = eta * i + (eta * cos_i - F(np.sqrt(k))) * n
    return normalize(r), False


# ---------------------------------------------------------------------------
# scene access (numpy views of the JAX Scene)
# ---------------------------------------------------------------------------

class OracleScene:
    def __init__(self, scene):
        self.verts = np.asarray(scene.vertices, F)       # [T,3,3]
        self.normals = np.asarray(scene.normals, F)
        self.uvs = np.asarray(scene.uvs, F)
        self.mat_ids = np.asarray(scene.mat_ids)
        self.mat = np.asarray(scene.materials.attrs, F)  # [M,32]
        quads = np.asarray(scene.materials.texture_quads)
        # texel colour = word 0 of the quad row
        w0 = quads[:, 0]
        self.texels = np.stack(
            [(w0 & 0xFF), (w0 >> 8) & 0xFF, (w0 >> 16) & 0xFF], -1
        ).astype(F) * F(1.0 / 255.0)                     # [P,3]
        self.env = np.asarray(scene.env.data, F)
        self.alias = (
            np.asarray(scene.env.alias_table, F)
            if scene.env.alias_table is not None
            else None
        )

        v0 = self.verts[:, 0]
        self.e1 = self.verts[:, 1] - v0
        self.e2 = self.verts[:, 2] - v0
        self.v0 = v0

    def occluded(self, o, d, t_min, t_max) -> bool:
        """Any-hit query (shadow ray), matching ops/intersect semantics."""
        p = np.cross(np.broadcast_to(d, self.e2.shape), self.e2)
        det = np.einsum("tk,tk->t", self.e1, p)
        with np.errstate(divide="ignore"):
            inv = np.where(np.abs(det) > 1e-12, 1.0 / det, 0.0).astype(F)
        tv = (o - self.v0).astype(F)
        u = np.einsum("tk,tk->t", tv, p) * inv
        q = np.cross(tv, self.e1)
        v = np.einsum("k,tk->t", d, q) * inv
        t = np.einsum("tk,tk->t", self.e2, q) * inv
        ok = (
            (np.abs(det) > 1e-12)
            & (u >= 0) & (v >= 0) & (u + v <= 1)
            & (t > t_min) & (t < t_max)
        )
        return bool(ok.any())

    def sample_env_alias(self, u1, u2, u3, u4):
        """Scalar mirror of envmap.sample_env_alias (one alias-table row)."""
        h, w = self.env.shape[:2]
        n = h * w
        i = min(int(u1 * n), n - 1)
        row = self.alias[i]
        take_self = u2 < row[0]
        texel = i if take_self else int(row[1])
        pmass = F(row[2] if take_self else row[3])
        ty, tx = texel // w, texel % w
        u = F((tx + u3) / w)
        v = F((ty + u4) / h)
        phi = F((u - 0.5) * (2 * np.pi))
        theta = F((0.5 - v) * np.pi)
        y = F(np.sin(theta))
        c = F(np.cos(theta))
        d = np.array([c * np.cos(phi), y, c * np.sin(phi)], F)
        # pdf at the sampled elevation (see envmap.sample_env_alias)
        cos_elev = F(max(float(np.cos((0.5 - v) * np.pi)), 1e-6))
        pdf = F(pmass * (h * w) / (2.0 * np.pi * np.pi * cos_elev))
        return d, pdf, u, v

    def pdf_env_alias(self, d):
        """Scalar mirror of envmap.env_pdf_alias (mass gather + Jacobian)."""
        h, w = self.env.shape[:2]
        dn = normalize(d)
        u = F(0.5 + np.arctan2(dn[2], dn[0]) / (2 * np.pi))
        v = F(0.5 - np.arcsin(np.clip(dn[1], -1, 1)) / np.pi)
        col = min(max(int(u * w), 0), w - 1)
        row = min(max(int(v * h), 0), h - 1)
        pmass = F(self.alias[row * w + col, 2])
        cos_elev = F(max(float(np.cos((0.5 - v) * np.pi)), 1e-6))
        return F(pmass * (h * w) / (2.0 * np.pi * np.pi * cos_elev)), u, v

    def intersect(self, o, d, t_min, t_max):
        """Brute-force closest hit; min-prim tie-break like the JAX path."""
        p = np.cross(np.broadcast_to(d, self.e2.shape), self.e2)
        det = np.einsum("tk,tk->t", self.e1, p)
        with np.errstate(divide="ignore"):
            inv = np.where(np.abs(det) > 1e-12, 1.0 / det, 0.0).astype(F)
        tv = (o - self.v0).astype(F)
        u = np.einsum("tk,tk->t", tv, p) * inv
        q = np.cross(tv, self.e1)
        v = np.einsum("k,tk->t", d, q) * inv
        t = np.einsum("tk,tk->t", self.e2, q) * inv
        ok = (
            (np.abs(det) > 1e-12)
            & (u >= 0) & (v >= 0) & (u + v <= 1)
            & (t > t_min) & (t < t_max)
        )
        if not ok.any():
            return None
        t = np.where(ok, t, np.inf)
        tmin = t.min()
        prim = int(np.flatnonzero(t == tmin).min())
        return prim, F(tmin), F(u[prim]), F(v[prim])

    def sample_texture(self, off, w, h, u, v):
        """Repeat-wrap bilinear over u8 texels (texsample semantics)."""
        u = u - np.floor(u)
        v = v - np.floor(v)
        x = F(u * w - 0.5)
        y = F(v * h - 0.5)
        x0f, y0f = np.floor(x), np.floor(y)
        s, t = F(x - x0f), F(y - y0f)
        x0, y0 = int(x0f) % w, int(y0f) % h
        x1, y1 = (x0 + 1) % w, (y0 + 1) % h
        c00 = self.texels[off + y0 * w + x0]
        c10 = self.texels[off + y0 * w + x1]
        c01 = self.texels[off + y1 * w + x0]
        c11 = self.texels[off + y1 * w + x1]
        c0 = c00 + (c10 - c00) * s
        c1 = c01 + (c11 - c01) * s
        return (c0 + (c1 - c0) * t).astype(F)

    def eval_env(self, d, cfg, uv=None):
        """uv: exact equirect coords when known (NEE alias draws) —
        mirrors envmap.eval_env(uv=...)."""
        if cfg.env_mode == "constant":
            return np.asarray(cfg.env_constant, F)
        dn = normalize(d)
        if cfg.env_mode == "sunsky":
            sun = normalize(np.array([0, 2, 3], F))
            if dn @ sun > 0.99:
                return np.array([200, 175, 125], F)
            return np.array([0.4, 0.4, 0.6], F)
        h, w = self.env.shape[:2]
        if uv is not None:
            u, v = uv
        else:
            u = 0.5 + np.arctan2(dn[2], dn[0]) / (2 * np.pi)
            v = 0.5 - np.arcsin(np.clip(dn[1], -1, 1)) / np.pi
        x = F(u * w - 0.5)
        y = F(v * h - 0.5)
        x0f, y0f = np.floor(x), np.floor(y)
        s, t = F(x - x0f), F(y - y0f)
        x0 = int(x0f) % w
        x1 = (x0 + 1) % w
        y0 = min(max(int(y0f), 0), h - 1)
        y1 = min(y0 + 1, h - 1)
        c0 = self.env[y0, x0] + (self.env[y0, x1] - self.env[y0, x0]) * s
        c1 = self.env[y1, x0] + (self.env[y1, x1] - self.env[y1, x0]) * s
        return (c0 + (c1 - c0) * t).astype(F)


# ---------------------------------------------------------------------------
# shading (render/integrator._shade, scalar; reference cu:616-872)
# ---------------------------------------------------------------------------

def _shade(sc: OracleScene, cfg, prim, t_hit, beta, gamma, o, d, seed, depth):
    tri_v = sc.verts[prim]
    tri_n = sc.normals[prim]
    tri_uv = sc.uvs[prim]
    mat = int(sc.mat_ids[prim])
    ma = sc.mat[mat]

    v0, v1, v2 = tri_v
    flat_n = normalize(np.cross(v1 - v0, v2 - v0))
    if float(-d @ flat_n) < 0:
        flat_n = -flat_n

    alpha_b = F(1.0) - beta - gamma
    wgt = np.array([alpha_b, beta, gamma], F)
    uv = wgt @ tri_uv
    tex_u = F(uv[0])
    tex_v = F(1.0 - uv[1]) if cfg.flip_v else F(uv[1])

    n_raw = (wgt @ tri_n).astype(F)
    degenerate = float(np.sqrt(n_raw @ n_raw)) <= 0.01
    normal = normalize(n_raw)
    if float(normal @ d) > 0:
        normal = flat_n

    hit_pos = (o + t_hit * d).astype(F)

    has_map = ma[S.MAT_HAS_MAP] > 0.5
    offs = ma[S.MAT_MAP_OFFSET].astype(int)
    ws = ma[S.MAT_MAP_WIDTH].astype(int)
    hs = ma[S.MAT_MAP_HEIGHT].astype(int)

    def prop(kind, fallback):
        if has_map[kind]:
            return sc.sample_texture(offs[kind], ws[kind], hs[kind], tex_u, tex_v)
        return np.asarray(fallback, F)

    albedo = prop(0, ma[S.MAT_DIFFUSE])
    nmap = prop(2, np.array([0, 1, 0], F))
    if has_map[2]:
        dec = normalize(F(2.0) * nmap - F(1.0))
        nmap = np.array([dec[0], dec[2], dec[1]], F)
    t1, b1 = onb(normal)
    nmap_world = onb_transform(nmap, t1, normal, b1)
    s_ = F(cfg.normal_map_strength)
    normal = normalize(s_ * nmap_world + (F(1.0) - s_) * normal)

    emission = ma[S.MAT_EMISSION].astype(F)
    rough = F(prop(1, np.full(3, ma[S.MAT_ROUGHNESS], F))[0])
    metal = F(prop(3, np.full(3, ma[S.MAT_METALLIC], F))[0])
    transparent = ma[S.MAT_TRANSPARENT] > 0.5
    # Per-material IOR (MTL Ni) where specified; cfg.ior otherwise —
    # mirrors integrator._shade.
    ior = F(ma[S.MAT_IOR]) if ma[S.MAT_IOR] > 0.0 else F(cfg.ior)

    emissive = float(np.sqrt(emission @ emission)) > 0.0001

    if cfg.seed_advance_quirk:
        seed, _ = random_in_unit_sphere(seed)

    rough = F(np.clip(rough, cfg.roughness_min, cfg.roughness_max))
    depth_done = depth <= 0

    seed, r1 = uniform(seed)
    seed, r2 = uniform(seed)
    alpha = F(rough * rough)
    phi = F(2 * np.pi) * r1
    cos_t = F(np.sqrt((1 - r2) / (1 + (alpha * alpha - 1) * r2)))
    sin_t = F(np.sqrt(max(0.0, 1 - cos_t * cos_t)))
    half_local = normalize(np.array([sin_t * np.cos(phi), cos_t, sin_t * np.sin(phi)], F))
    t2, b2 = onb(normal)
    half = onb_transform(half_local, t2, normal, b2)
    light_dir = reflect(d, half)

    seed, r3 = uniform(seed)
    seed, r4 = uniform(seed)
    rr_ = F(np.sqrt(r3))
    phi2 = F(2 * np.pi) * r4
    lx = rr_ * F(np.cos(phi2))
    lz = rr_ * F(np.sin(phi2))
    ly = F(np.sqrt(max(0.0, 1 - lx * lx - lz * lz)))
    light_diffuse = onb_transform(np.array([lx, ly, lz], F), t2, normal, b2)

    f0s = F(((1 - ior) / (1 + ior)) ** 2)
    f0 = f0s + (albedo - f0s) * metal
    ndotv_raw = F(normal @ -d)
    cosc = F(np.clip(max(ndotv_raw, 0.0), 0, 1))
    f_vec = f0 + (1 - f0) * F((1 - cosc) ** 5)
    ndoth = F(max(normal @ half, 1e-10))
    a2 = alpha * alpha
    denom_d = ndoth * ndoth * (a2 - 1) + 1
    # Same f32 inf-guard as bsdf.d_ggx: the inner term can round to
    # exactly 0 at tiny alpha with ndoth ~= 1.
    d_term = F(a2 / max(np.pi * denom_d * denom_d, 1e-12))

    def g1(x):
        ndotx = abs(float(normal @ x))
        k = alpha / 2
        return F(ndotx / max(ndotx * (1 - k) + k, 1e-10))

    g_term = g1(-d) * g1(light_dir)
    denom = F(4 * abs(ndotv_raw) * abs(normal @ light_dir))
    brdf_spec = f_vec * F(d_term * g_term / max(denom, 1e-10))

    vdoth = F(max(-d @ half, 1e-10))
    ndotv = F(max(ndotv_raw, 0.0))
    idotn = F(abs(normal @ normalize(light_dir)))
    r0 = F(((1 - ior) / (1 + ior)) ** 2)
    f_blend = F(r0 + (1 - r0) * (1 - ndotv) ** 5)
    spec_prob = F(metal + (1 - metal) * f_blend)
    spdf = F(d_term * ndoth / (4 * vdoth))
    dpdf = F(1 / np.pi)

    seed, u_lobe = uniform(seed)
    choose_spec = u_lobe < spec_prob
    dir_surface = normalize(light_dir) if choose_spec else normalize(light_diffuse)
    brdf = spec_prob * (brdf_spec / max(spdf, F(1e-20))) + (1 - spec_prob) * (albedo / dpdf)

    # glass branch draws happen for every lane in the vectorized code
    cos_ti = F(normal @ -d)
    inside = cos_ti < 0
    n_glass = -normal if inside else normal
    eta_passed = F(1.0 / ior) if inside else ior
    cos_i = F(abs(cos_ti))
    reflectance = F(r0 + (1 - r0) * (1 - cos_i) ** 5)
    seed, u_reflect = uniform(seed)
    refr, _tir = refract_sutil(d, n_glass, eta_passed)
    seed, sphere_pt = random_in_unit_sphere(seed)
    refr_pert = refr + F(cfg.glass_roughness_perturb) * alpha * sphere_pt
    glass_dir = light_dir if u_reflect < reflectance else refr_pert

    new_dir = glass_dir if transparent else dir_surface
    brdf_ok = float(np.sqrt(brdf @ brdf)) >= 1e-10
    att_factor = (brdf * idotn).astype(F)
    att_ok = brdf_ok and not transparent and not emissive and not degenerate
    done = degenerate or emissive or depth_done

    return dict(
        origin=hit_pos, direction=new_dir, att_factor=att_factor,
        att_ok=att_ok, emission=emission, emissive=emissive and not degenerate,
        done=done, seed=seed,
        # NEE extras (mirror integrator._shade's return)
        normal=normal, brdf=brdf, spec_prob=spec_prob, idotn=idotn,
        degenerate=degenerate, glass=transparent, choose_spec=choose_spec,
        # spec-lobe MIS extras (cfg.nee_mis_spec)
        spec_dir=normalize(light_dir), spec_pdf=spdf, f_vec=f_vec,
        alpha=alpha, albedo=albedo,
    )


# ---------------------------------------------------------------------------
# per-pixel path tracing (render_rays, scalar)
# ---------------------------------------------------------------------------

def render_pixel(sc: OracleScene, cam, cfg, pixel: int, subframe: int) -> np.ndarray:
    eye = np.asarray(cam["eye"], F)
    u_vec = np.asarray(cam["U"], F)
    v_vec = np.asarray(cam["V"], F)
    w_vec = np.asarray(cam["W"], F)
    px, py = pixel % cfg.width, pixel // cfg.width

    total = np.zeros(3, F)
    for sample in range(cfg.samples_per_launch):
        seed = make_seed(pixel, sample, subframe)
        seed, jx = uniform(seed)
        seed, jy = uniform(seed)
        dx = F(2.0) * (px + jx) / F(cfg.width) - F(1.0)
        dy = F(2.0) * (py + jy) / F(cfg.height) - F(1.0)
        target = (dx * u_vec + dy * v_vec + w_vec).astype(F)
        if cfg.dof:
            local = seed
            local, r_u = uniform(local)
            local, th_u = uniform(local)
            r = F(np.sqrt(r_u))
            th = F(2 * np.pi) * th_u
            rad = F(cfg.dof_blurriness) * F(np.sqrt(r))
            off = rad * F(np.cos(th)) * u_vec + rad * F(np.sin(th)) * v_vec
            direction = normalize(F(cfg.focus_distance) * target - off)
            origin = (off + eye).astype(F)
        else:
            direction = normalize(target)
            origin = eye.copy()

        att = np.ones(3, F)
        radiance = np.zeros(3, F)
        depth = cfg.max_depth
        result = np.zeros(3, F)
        nee = cfg.env_importance_sampling
        spec_last = True  # primaries count specular (integrator parity)

        for _ in range(cfg.max_depth + 2):
            hit = sc.intersect(origin, direction, cfg.t_min, cfg.t_max)
            if hit is None:
                # With NEE, env misses are credited only to spec-sampled
                # segments (the diffuse share is handled by light sampling).
                # Under spec-lobe MIS, spec_last carries the balance
                # weight (float) instead of the boolean.
                if nee and cfg.nee_mis_spec:
                    radiance = radiance + att * sc.eval_env(direction, cfg) * F(spec_last)
                elif not nee or spec_last:
                    radiance = radiance + att * sc.eval_env(direction, cfg)
                done = True
            else:
                prim, t_hit, bu, bv = hit
                sh = _shade(sc, cfg, prim, t_hit, bu, bv, origin, direction, seed, depth)
                seed = sh["seed"]
                if sh["emissive"]:
                    radiance = radiance + att * sh["emission"]
                if nee:
                    # Same draw order and estimator as _trace_bounce.
                    seed, u1 = uniform(seed)
                    seed, u2 = uniform(seed)
                    seed, u3 = uniform(seed)
                    seed, u4 = uniform(seed)
                    env_dir, env_pdf, env_u, env_v = sc.sample_env_alias(
                        u1, u2, u3, u4
                    )
                    if cfg.nee_defensive_mix:
                        # Defensive mixture, draw-for-draw with the
                        # integrator: u5 picks the branch, u3/u4 are
                        # reused for the cosine draw, u6 is a discarded
                        # pair-parity draw.
                        seed, u5 = uniform(seed)
                        seed, _u6 = uniform(seed)
                        t_n, b_n = onb(sh["normal"])
                        rr_c = F(np.sqrt(u3))
                        phi_c = F(2 * np.pi) * u4
                        cx = rr_c * F(np.cos(phi_c))
                        cz = rr_c * F(np.sin(phi_c))
                        cy = F(np.sqrt(max(0.0, 1 - cx * cx - cz * cz)))
                        dir_cos = onb_transform(
                            np.array([cx, cy, cz], F), t_n, sh["normal"], b_n
                        )
                        if u5 < 0.5:
                            p_alias = env_pdf
                        else:
                            p_alias, env_u, env_v = sc.pdf_env_alias(dir_cos)
                            env_dir = dir_cos
                        cos_sel = F(max(float(sh["normal"] @ env_dir), 0.0))
                        env_pdf = F(0.5 * p_alias + 0.5 * cos_sel / np.pi)
                    cos_l = F(max(float(sh["normal"] @ env_dir), 0.0))
                    nee_ok = (
                        not sh["done"]  # depth parity with the base estimator
                        and not sh["glass"] and not sh["emissive"]
                        and not sh["degenerate"] and cos_l > 0.0
                        and not sc.occluded(sh["origin"], env_dir, cfg.t_min, cfg.t_max)
                    )
                    if nee_ok:
                        l_env = sc.eval_env(env_dir, cfg, uv=(env_u, env_v))
                        weight = F(
                            (1.0 - sh["spec_prob"]) * sh["idotn"] * cos_l
                            / (np.pi * max(float(env_pdf), 1e-12))
                        )
                        contrib = att * sh["brdf"] * weight * l_env
                        if cfg.nee_mis_spec:
                            # Light-arm spec term (same draw + shadow ray),
                            # mirroring integrator._trace_bounce.
                            view = -direction
                            h_l = normalize(view + env_dir)
                            ndoth_l = F(max(float(sh["normal"] @ h_l), 1e-10))
                            a2l = F(sh["alpha"] * sh["alpha"])
                            dd_l = F(ndoth_l * ndoth_l * (a2l - 1) + 1)
                            d_term_l = F(
                                a2l / max(np.pi * dd_l * dd_l, 1e-12)
                            )
                            k_l = F(sh["alpha"] / 2)

                            def g1_l(x):
                                nx = abs(float(sh["normal"] @ x))
                                return F(nx / max(nx * (1 - k_l) + k_l, 1e-10))

                            g_term_l = F(g1_l(view) * g1_l(env_dir))
                            ndotv_l = F(sh["normal"] @ view)
                            denom_l = F(
                                4 * abs(ndotv_l)
                                * abs(float(sh["normal"] @ env_dir))
                            )
                            brdf_spec_l = sh["f_vec"] * F(
                                d_term_l * g_term_l / max(denom_l, 1e-10)
                            )
                            vdoth_l = F(max(float(view @ h_l), 1e-10))
                            p_ggx_l = F(d_term_l * ndoth_l / (4 * vdoth_l))
                            w_l = F(
                                env_pdf / max(env_pdf + p_ggx_l, 1e-20)
                            )
                            g_spec = (
                                sh["spec_prob"]
                                * (
                                    sh["spec_prob"] * brdf_spec_l
                                    + (1 - sh["spec_prob"]) * np.pi
                                    * p_ggx_l * sh["albedo"]
                                )
                                * cos_l
                            )
                            contrib = contrib + att * g_spec * F(
                                w_l / max(float(env_pdf), 1e-12)
                            ) * l_env
                        radiance = radiance + contrib
                    if cfg.nee_mis_spec:
                        p_alias_s, _, _ = sc.pdf_env_alias(sh["spec_dir"])
                        if cfg.nee_defensive_mix:
                            cos_s = F(max(float(sh["normal"] @ sh["spec_dir"]), 0.0))
                            p_light_s = F(0.5 * p_alias_s + 0.5 * cos_s / np.pi)
                        else:
                            p_light_s = p_alias_s
                        if sh["glass"]:
                            spec_last = 1.0
                        elif sh["choose_spec"]:
                            spec_last = float(
                                sh["spec_pdf"]
                                / max(float(sh["spec_pdf"] + p_light_s), 1e-20)
                            )
                        else:
                            spec_last = 0.0
                    else:
                        spec_last = bool(sh["choose_spec"]) or bool(sh["glass"])
                if sh["att_ok"]:
                    att = att * sh["att_factor"]
                done = sh["done"]

            seed, u_rr = uniform(seed)
            p = F(att.max())
            rr_done = done or (u_rr > p)
            if rr_done:
                p_safe = p if p > 0 else F(1.0)
                if cfg.rr_mode == "reference":
                    result = radiance / p_safe
                else:
                    result = radiance
                break
            if cfg.rr_mode == "standard":
                # survival prob is min(p,1) — see integrator.render_rays
                att = att / F(min(p if p > 0 else 1.0, 1.0))
            origin = sh["origin"]
            direction = sh["direction"]
            depth -= 1
        total += result
    return total / F(cfg.samples_per_launch)


def render(scene, cam, cfg, pixels, subframe: int = 0) -> np.ndarray:
    """Render a list of flat pixel ids; returns [len(pixels),3] radiance."""
    sc = OracleScene(scene)
    cam_np = {k: np.asarray(v, F) for k, v in cam.items()}
    return np.stack([render_pixel(sc, cam_np, cfg, int(p), subframe) for p in pixels])
