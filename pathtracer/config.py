"""Render configuration.

The reference hard-codes every rendering constant inside its kernels and
host code (reference optixSphere.cu:309,323,360,412,425,432 and
optixSphere.cpp:104-107,829-841).  Here every one of those constants is a
field of a single frozen dataclass so it is (a) discoverable, (b) test-able
and (c) hashable, which lets the whole config ride into `jax.jit` as a
static argument.

Reference-derived defaults are annotated with their source lines.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration for one render.  Hashable -> jit-static."""

    # ---- image / launch geometry -------------------------------------
    width: int = 1600                # reference optixSphere.cpp:760 (release)
    height: int = 1200               # reference optixSphere.cpp:761
    samples_per_launch: int = 10     # `sample_batch_count` optixSphere.cu:323
    max_depth: int = 20              # payload.depth init, optixSphere.cu:360

    # ---- ray parameters ----------------------------------------------
    t_min: float = 0.01              # optixSphere.cu:368
    t_max: float = 1e16              # optixSphere.cu:369

    # ---- camera / depth of field -------------------------------------
    dof: bool = True                 # `bool dof = true` optixSphere.cpp:92
    dof_blurriness: float = 0.01     # optixSphere.cu:285
    focus_distance: float = 1.0      # optixSphere.cu:329

    # ---- BSDF constants ------------------------------------------------
    ior: float = 1.5                 # optixSphere.cu:717
    normal_map_strength: float = 0.4  # optixSphere.cu:697
    roughness_min: float = 0.015     # optixSphere.cu:735
    roughness_max: float = 0.999     # optixSphere.cu:736
    flip_v: bool = True              # uv.y = 1 - uv.y, optixSphere.cu:659
    # Glass refraction roughness perturbation scale, optixSphere.cu:848
    glass_roughness_perturb: float = 0.8

    # ---- film / post chain ---------------------------------------------
    exposure: float = -0.5           # optixSphere.cu:412
    gamma: float = 2.2               # optixSphere.cu:425
    contrast: float = 1.25           # optixSphere.cu:432
    # The reference additionally passes through the OptiX SDK's
    # `make_color`, which applies an sRGB transfer curve on top of the
    # manual gamma (cuda/helpers.h `toSRGB`; call at optixSphere.cu:435).
    srgb_output: bool = True

    # ---- wavefront scheduling --------------------------------------------
    # Path regeneration ("persistent lanes"): one lane per pixel consumes
    # its samples sequentially, respawning a fresh camera ray the moment a
    # path terminates.  Keeps lane utilisation near 100% vs letting dead
    # lanes ride the bounce loop (the megakernel schedule wastes ~85% of
    # lane-iterations at reference RR rates).  Falls back to the wide
    # schedule when samples_per_launch == 1 (nothing to respawn).
    regenerate: bool = True
    # Lane-pool size for the streaming work-queue renderer (big launches
    # stream all pixels through this many persistent lanes; the straggler
    # tail is paid once per frame instead of once per tile).  0 = auto:
    # nearest power of two to n_pix/16, clamped to [16384, 131072] —
    # the pool should scale with the frame, because the queue's drain
    # tail costs one pool's worth of partially-idle iterations per frame.
    # Not yet re-tuned on the GPU.
    stream_lanes: int = 0

    # Pixel hand-out order for the streaming renderer.  "auto" = scanline;
    # "tiled" (consecutive lanes cover a 16x8 pixel block; requires
    # width%16==0 and height%8==0) is an explicit experimental option.
    # Output is bitwise identical either way (seeds key off the pixel id).
    pixel_order: str = "auto"       # "auto" | "scanline" | "tiled"

    # ---- estimator behaviour -------------------------------------------
    # "reference": clone the reference's quirky estimator exactly:
    #   path_rgb = payload.radiance; on termination path_rgb /= p
    #   (optixSphere.cu:376-387).
    # "standard": textbook Russian roulette — divide *attenuation* by the
    #   survival probability for surviving paths (unbiased).
    rr_mode: str = "reference"
    # Reference keeps a discarded random_in_unit_sphere(seed) call that
    # advances the RNG ("needed to avoid artifacts", optixSphere.cu:733).
    # We default it off because our lanes have independent seeds; flip on
    # for estimator-parity experiments.
    seed_advance_quirk: bool = False

    # ---- environment lighting ------------------------------------------
    # "equirect" = HDR image (optixSphere.cu:548-550),
    # "sunsky"   = procedural fallback (optixSphere.cu:552-557),
    # "constant" = flat colour sky (ours — used by test configs).
    env_mode: str = "equirect"
    env_constant: Tuple[float, float, float] = (0.4, 0.4, 0.6)
    # Environment-map CDF importance sampling (exceeds the reference — its
    # NEE path is dead code, optixSphere.cu:134-156, 858).
    env_importance_sampling: bool = False
    # Defensive one-sample mixture for the NEE light sample: draw the env
    # direction from 0.5*alias + 0.5*cosine and divide by the mixture pdf
    # (balance heuristic).  Targets the measured weakness of pure
    # luminance-proportional sampling — broad-sky speckle where the
    # cosine factor, not luminance, shapes the integrand; bounds the
    # weight at 2x the pure cosine estimator's where the alias pdf is a
    # bad match.
    nee_defensive_mix: bool = False
    # Multi-queue NEE: instead of a separate any-hit
    # kernel launch per bounce, the shadow ray rides the NEXT bounce's
    # closest-hit batch (2x lanes, ONE kernel pass, one shared ray sort).
    # The deferred contribution is resolved one iteration later; paths
    # killed by Russian roulette in between drop it, and survivors scale
    # it by 1/p_survive — unbiased (E[1{survive}/p] = 1), but a different
    # estimator from the immediate-resolve path, so it is gated
    # statistically (tests/test_envmap.py) rather than bitwise.
    # "auto" = off (not measured on the GPU yet); "on"/"off" force.
    nee_multi_queue: str = "auto"   # "auto" | "on" | "off"
    # Spec-lobe MIS (one-sample balance heuristic) between GGX sampling
    # and the env light sample: env credits on spec-sampled misses are
    # weighted p_ggx/(p_ggx + p_light), and the matching light-sampled
    # spec term rides the existing NEE shadow ray (no extra occlusion
    # cost).  Attacks rough-GGX samples hitting the small bright sun at
    # low pdf.
    nee_mis_spec: bool = False

    # ---- performance knobs ----------------------------------------------
    # Rays are processed in flat batches of (tile pixels x samples); tiles
    # bound live HBM. 0 = whole frame in one batch.
    tile_pixels: int = 0
    # Triangle-block size for the blocked brute-force intersector.
    intersect_block: int = 256
    # Which intersector: "auto" | "brute" | "cluster"
    intersector: str = "auto"
    # Sort rays before the GPU packet kernel (ClusterAccel.intersect).
    # Packets whose rays share a direction octant cull clusters far
    # better (the per-packet front-to-back order is then right for every
    # lane).  "spatial" sorts by (origin Morton cell, octant) — spread-out
    # many-cluster scenes diverge by POSITION, and a pure octant sort
    # interleaves rays from the whole frame; "octant" sorts by direction
    # octant alone.  "auto" = spatial for every scene with more than one
    # cluster.  The XLA (CPU) traversal never sorts.
    sort_rays: str = "auto"  # "auto" | "off" | "octant" | "spatial"
    # Morton bits per axis for the spatial key (cells = 2^bits per axis).
    # 0 = auto: 7 for compact scenes (< 256 clusters), 5 for spread ones
    # (finer cells over-fragment the queue order there).
    sort_spatial_bits: int = 0
    # Direction-magnitude bits per axis appended BELOW the octant bits of
    # the sort key (ops/intersect_pallas.ray_sort_key).  Primary lanes
    # all share one origin cell, so without refinement a packet is R
    # consecutive queue lanes of one octant — a scanline row's spread of
    # directions; quantising |d| groups them into tight frustum wedges
    # while bounce packets barely move.  0 = auto (ClusterAccel._dir_bits:
    # 3 bits on >= 256-cluster scenes, else 2); -1 = off.  Clamped so the
    # key fits u32.
    sort_dir_bits: int = 0
    # Deferred (hit-compacted) shading: instead of running the closest-hit
    # program on every lane (miss lanes pay the texture-bundle gather and
    # the full GGX math for nothing — ~60% of traced segments are misses
    # on the hero scene), compact hit lanes into dense chunks of
    # lanes/deferred_chunk_div via a prefix-sum scatter and shade only
    # those.  Each path's RNG chain and shade math are untouched — output
    # matches the dense schedule to within XLA's shape-dependent rounding
    # (<= 1 ULP; fusion/FMA choices differ for chunk-shaped arrays), which
    # is why it is opt-in rather than the default.
    deferred_shade: bool = False
    deferred_chunk_div: int = 4
    # Rays per GPU kernel packet (one thread block).  Smaller packets cull
    # clusters more precisely (the per-packet slab test unions fewer
    # rays); bigger ones amortise per-cluster overhead.  0 = auto
    # (accel/cluster.KERNEL_SHAPES, chosen by measurement).
    pallas_rays_per_tile: int = 0
    # Cluster count at or above which the GPU kernel walks two levels:
    # one slab test per super-cluster (`super_branch` Morton-consecutive
    # clusters) before its children.
    hier_min_clusters: int = 96
    # Streaming renderer: retire-FIFO depth per lane and flush cadence
    # (iterations between batched output scatters into the image).  The
    # flush cadence should sit near the FIFO fill time.
    fifo_depth: int = 4
    flush_every: int = 32
    # Texture LOD (mip) policy.  Scenes whose bundled texture pool
    # exceeds ~16 MB get a box-filtered mip pool built alongside.
    #   "off"   — always sample the full-res pool (strict reference
    #             parity; the reference is bilinear-only, optixSphere
    #             .cu:569-596).
    #   "mip"   — every lane samples the mip pool.
    #   "split" — primary path segments sample full-res, secondary
    #             bounces sample the mip (direct texture detail exact).
    #   "auto"  — "off" (the mip costs visible texture detail).
    # Scenes with small texture pools never build a mip, so every mode
    # is exactly "off" for them (all goldens/parity tests unaffected).
    texture_lod: str = "auto"       # "auto" | "off" | "mip" | "split"
    # Accumulation dtype for the film. float32 matches the reference.
    accum_dtype: str = "float32"

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        if self.rr_mode not in ("reference", "standard"):
            raise ValueError(f"invalid rr_mode: {self.rr_mode!r}")
        if self.env_importance_sampling and self.rr_mode == "reference":
            # Under the reference's quirky estimator the terminal `/p`
            # division (optixSphere.cu:382-387) would rescale mid-path NEE
            # contributions by an unrelated FUTURE survival probability —
            # an estimator combination the base renderer never produces
            # and no parity test validates.  NEE is a beyond-reference
            # feature; it requires the textbook estimator.
            raise ValueError(
                "env_importance_sampling (NEE) requires rr_mode='standard': "
                "the reference RR estimator's terminal /p division would "
                "bias mid-path NEE contributions"
            )
        if self.nee_defensive_mix and not self.env_importance_sampling:
            raise ValueError(
                "nee_defensive_mix is a mode OF the NEE light sample: "
                "it requires env_importance_sampling=True"
            )
        if self.nee_multi_queue not in ("auto", "on", "off"):
            raise ValueError(
                f"invalid nee_multi_queue: {self.nee_multi_queue!r}"
            )
        if self.nee_mis_spec and not self.env_importance_sampling:
            raise ValueError(
                "nee_mis_spec combines the spec lobe WITH the NEE light "
                "sample: it requires env_importance_sampling=True"
            )
        if self.env_mode not in ("equirect", "sunsky", "constant"):
            raise ValueError(f"invalid env_mode: {self.env_mode!r}")
        if self.intersector not in ("auto", "brute", "cluster"):
            raise ValueError(f"invalid intersector: {self.intersector!r}")
        if self.pixel_order not in ("auto", "scanline", "tiled"):
            raise ValueError(f"invalid pixel_order: {self.pixel_order!r}")
        if self.sort_rays not in ("auto", "off", "octant", "spatial"):
            raise ValueError(f"invalid sort_rays: {self.sort_rays!r}")
        if self.texture_lod not in ("auto", "off", "mip", "split"):
            raise ValueError(f"invalid texture_lod: {self.texture_lod!r}")
        if not (0 <= self.sort_spatial_bits <= 9):
            # 3*bits + 3 octant bits must fit a uint32 sort key.
            raise ValueError(
                f"sort_spatial_bits must be 0 (auto) to 9: {self.sort_spatial_bits}"
            )
        if not (-1 <= self.sort_dir_bits <= 4):
            raise ValueError(
                f"sort_dir_bits must be -1 (off), 0 (auto) or 1..4: "
                f"{self.sort_dir_bits}"
            )
        if self.hier_min_clusters < 2:
            # 1 would route every clustered scene through the super level;
            # a single-cluster scene has nothing to skip.
            raise ValueError(
                f"hier_min_clusters must be >= 2: {self.hier_min_clusters}"
            )
        if self.stream_lanes < 0:
            raise ValueError(
                f"stream_lanes must be >= 0 (0 = auto): {self.stream_lanes}"
            )
        if self.fifo_depth < 1:
            # fifo_depth=0 would silently drop every retired pixel (the
            # staging loop never writes) and render black.
            raise ValueError(f"fifo_depth must be >= 1: {self.fifo_depth}")
        if self.flush_every < 1:
            raise ValueError(f"flush_every must be >= 1: {self.flush_every}")
        if self.deferred_chunk_div < 1:
            raise ValueError(
                f"deferred_chunk_div must be >= 1: {self.deferred_chunk_div}"
            )
        if self.pixel_order == "tiled" and (
            self.width % 16 or self.height % 8
        ):
            raise ValueError(
                "pixel_order='tiled' requires width%16==0 and height%8==0"
            )
