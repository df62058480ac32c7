"""Progressive rendering driver: the per-frame loop, camera-change
accumulation reset, checkpoint/resume, and per-frame metrics.

Replaces the reference's interactive loop state machine (reference
optixSphere.cpp:1360-1442): `updateState` resets `subframe_index` to 0 on
camera change or resize (cpp:267-278), every launch accumulates via EWMA
(optixSphere.cu:400-409), and `sutil::displayStats` shows frame timing
(cpp:1431).

The renderer's full state is (accumulation buffer, subframe index, camera,
config) — counter-based RNG makes that sufficient to resume *bitwise*
identically, which gives the checkpoint/resume + elastic-recovery story
the reference lacks (SURVEY.md §5): kill the process at any subframe,
reload, and the remaining subframes produce the same image.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import jax.numpy as jnp
import numpy as np

from pathtracer.config import RenderConfig
from pathtracer.render.camera import Camera
from pathtracer.render.film import (
    accumulate_weighted,
    post_process,
    to_uint8,
)
from pathtracer.render.integrator import camera_arrays, render_frame
from pathtracer.utils import logging as plog


class ProgressiveRenderer:
    """Owns the accumulation buffer and the subframe counter."""

    def __init__(self, scene, camera: Camera, cfg: RenderConfig, mesh=None, shard_mode: str = "pixels", preview_scale="auto", preview_budget_s: float = 0.125, denoise: bool = False):
        self.scene = scene
        # Edge-avoiding A-Trous denoise of the displayed/saved image,
        # guided by a per-camera G-buffer (render/aov.py).  Display-path
        # only: the accumulation buffer, checkpoints and the progressive
        # estimator are untouched (beyond-reference feature, off by
        # default — goldens unaffected).
        self.denoise = denoise
        self._aov = None
        self.cfg = cfg
        self.camera = camera.with_aspect(cfg.width, cfg.height)
        self.mesh = mesh
        self.shard_mode = shard_mode
        self.accum = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
        self.subframe = 0
        # Samples accumulated so far.  Tracked separately from subframe
        # because the converge ramp (step_converge) mixes launch sizes;
        # for constant-spp histories it equals subframe*samples_per_launch.
        self._accum_spp = 0
        self._cam_arrays = camera_arrays(self.camera, cfg)
        self.frame_times: list[float] = []
        self._frame_paths: list[int] = []  # traced paths per step, for stats
        # Adaptive preview: while the camera is moving the viewer renders
        # at 1/preview_scale resolution and 1 spp — the analog of the
        # reference's "reset accumulation and keep the loop interactive"
        # (optixSphere.cpp:267-278).  An int fixes the scale (0/1
        # disables); "auto" starts at 1/4 and steps the resolution FINER
        # while measured preview frames stay under preview_budget_s
        # (default 125 ms ~ 8 fps), down to full-res 1-spp previews on
        # hardware that affords them.  A scale that misses the budget is
        # blacklisted so the controller cannot oscillate (each scale is a
        # separate jit specialization; the persistent compile cache makes
        # revisits cheap across runs).
        self.preview_budget_s = preview_budget_s
        self._pv_auto = preview_scale == "auto"
        self._pv_scale = 4 if self._pv_auto else int(preview_scale or 0)
        self._pv_floor = 1          # finest scale auto may try
        self._pv_good = 0           # consecutive fast frames at the floor
        self._pv_times: dict[int, list] = {}
        self._preview_img: Optional[jnp.ndarray] = None

    @property
    def preview_scale(self) -> int:
        return self._pv_scale

    @property
    def _preview_cfg(self) -> Optional[RenderConfig]:
        return self._make_preview_cfg(self._pv_scale)

    def _make_preview_cfg(self, scale: int) -> Optional[RenderConfig]:
        if not scale:
            return None
        if scale <= 1:
            if not self._pv_auto:
                return None          # explicit 0/1 = previews disabled
            return self.cfg.replace(samples_per_launch=1)  # full-res 1 spp
        pw = max(16, (self.cfg.width // scale) // 16 * 16)
        ph = max(8, (self.cfg.height // scale) // 8 * 8)
        return self.cfg.replace(width=pw, height=ph, samples_per_launch=1)

    def _pv_update(self, dt: float) -> None:
        """Auto-preview controller: step finer while comfortably under
        budget, back off (and blacklist) a scale that misses it.

        The blacklist AGES: one bad 3-frame median (a host hiccup / GC
        pause) must not ban a scale for the whole session — after 8
        consecutive comfortably-fast frames at the floor, the next finer
        scale gets one fresh re-probe."""
        ts = self._pv_times.setdefault(self._pv_scale, [])
        ts.append(dt)
        del ts[:-8]                  # bounded per-scale history
        if len(ts) < 3:              # first sample includes the compile
            return
        med = sorted(ts[-3:])[1]
        if med > 1.25 * self.preview_budget_s and self._pv_scale < 16:
            self._pv_floor = max(self._pv_floor, self._pv_scale * 2)
            self._pv_scale *= 2
            self._pv_good = 0
        elif med < 0.5 * self.preview_budget_s:
            if self._pv_scale > self._pv_floor:
                self._pv_scale //= 2
            elif self._pv_floor > 1:
                self._pv_good += 1
                if self._pv_good >= 8:
                    self._pv_good = 0
                    self._pv_floor //= 2
                    self._pv_scale = self._pv_floor
                    # fresh samples: the re-probe's first (compile) frame
                    # must not re-condemn the scale
                    self._pv_times.pop(self._pv_scale, None)

    # -- camera interaction (reference cpp:238-278) ----------------------
    def set_camera(self, camera: Camera) -> None:
        """Camera change resets accumulation (cpp:270-271)."""
        self.camera = camera.with_aspect(self.cfg.width, self.cfg.height)
        self._cam_arrays = camera_arrays(self.camera, self.cfg)
        self._aov = None            # G-buffer is per-camera
        self.reset()

    def reset(self) -> None:
        self.accum = jnp.zeros_like(self.accum)
        self.subframe = 0
        self._accum_spp = 0
        self.frame_times.clear()
        self._frame_paths.clear()

    # -- adaptive preview (camera in motion) ------------------------------
    def step_preview(self) -> bool:
        """Render ONE low-res 1-spp frame into the preview buffer (shown
        by image_u8 until the next full-res step).  Returns False when
        previewing is disabled."""
        pcfg = self._preview_cfg
        if pcfg is None:
            return False
        t0 = time.perf_counter()
        pcam = camera_arrays(
            self.camera.with_aspect(pcfg.width, pcfg.height), pcfg
        )
        frame = render_frame(self.scene, pcam, pcfg, jnp.int32(self.subframe))
        if self.denoise:
            # 1-spp preview frames benefit most: one cheap G-buffer pass
            # at preview resolution (center rays, single intersect) turns
            # speckle into a stable image while the camera moves.
            from pathtracer.render.aov import (
                atrous_denoise, defocus_mask, render_aov,
            )

            paov = render_aov(self.scene, pcam, pcfg)
            frame = atrous_denoise(
                frame, paov, defocus=defocus_mask(paov, pcfg),
                iterations=3, sigma_color=4.0,
            )
        frame.block_until_ready()
        self._preview_img = frame
        if self._pv_auto:
            self._pv_update(time.perf_counter() - t0)
        return True

    # -- the per-frame step (cpp:1390-1437) -------------------------------
    def step(self, spp: Optional[int] = None) -> jnp.ndarray:
        """Render one launch, accumulate, advance subframe; returns accum.

        `spp` overrides the launch's sample count (the converge ramp);
        accumulation weights by sample count, so mixed-size launches stay
        an unbiased mean.  Default-spp histories are bitwise-unchanged
        (see film.accumulate_weighted).
        """
        launch_spp = spp or self.cfg.samples_per_launch
        cfg_l = (
            self.cfg
            if launch_spp == self.cfg.samples_per_launch
            else self.cfg.replace(samples_per_launch=launch_spp)
        )
        t0 = time.perf_counter()
        if self.mesh is not None:
            from pathtracer.parallel.shard import render_frame_sharded

            frame = render_frame_sharded(
                self.scene,
                self._cam_arrays,
                cfg_l,
                jnp.int32(self.subframe),
                self.mesh,
                mode=self.shard_mode,
            )
        else:
            frame = render_frame(
                self.scene, self._cam_arrays, cfg_l, jnp.int32(self.subframe)
            )
        self.accum = accumulate_weighted(
            self.accum, frame, self._accum_spp, launch_spp
        )
        self.accum.block_until_ready()
        dt = time.perf_counter() - t0
        self.frame_times.append(dt)
        self._frame_paths.append(
            self.cfg.width * self.cfg.height * launch_spp
        )
        self.subframe += 1
        self._accum_spp += launch_spp
        self._preview_img = None  # full-res data supersedes the preview
        return self.accum

    def step_converge(self) -> jnp.ndarray:
        """`step()`, but the first launches after a reset use a doubling
        sample ramp (1, 1, 2, 4, ... up to half the configured batch) so
        the display refines within roughly one 1-spp launch of the camera
        settling, instead of after a full-batch launch (the reference
        shows every 10-spp subframe as it lands, optixSphere.cpp:1390-1437;
        at full-frame launch times the same "first pixels fast" behavior
        needs smaller first batches).  Sharded renderers skip the ramp
        (mode="samples" requires spp % n_devices == 0)."""
        full = self.cfg.samples_per_launch
        if self.mesh is not None or full <= 2:
            return self.step()
        if self._accum_spp < full // 2:
            return self.step(spp=max(1, min(self._accum_spp, full // 2)))
        return self.step()

    def render_spp(self, total_spp: int, log_every: int = 10) -> jnp.ndarray:
        """Progressive loop until >= total_spp samples accumulated."""
        spp_per_frame = self.cfg.samples_per_launch
        n_frames = max(1, -(-total_spp // spp_per_frame))
        target = n_frames * spp_per_frame
        while self._accum_spp < target:
            self.step()
            if log_every and self.subframe % log_every == 0:
                plog.info(
                    "progressive",
                    f"subframe {self.subframe}/{n_frames} "
                    f"({self._accum_spp} spp, "
                    f"{self.frame_times[-1]*1e3:.1f} ms/frame)",
                )
        return self.accum

    @property
    def spp(self) -> int:
        return self._accum_spp

    def image_u8(self) -> np.ndarray:
        """Post-processed display image (row 0 = top, PNG convention).

        While a preview frame is pending (camera in motion, subframe 0 and
        nothing accumulated yet) it is shown instead — nearest-upscaled to
        the display size so the UI stays interactive at full quality cost
        ~1/(scale^2 * spp) of a real subframe."""
        if self._preview_img is not None and self.subframe == 0:
            pv = self._preview_img
            out = np.asarray(to_uint8(post_process(pv, self.cfg)))[::-1]
            ry = self.cfg.height / out.shape[0]
            rx = self.cfg.width / out.shape[1]
            yi = np.minimum(
                (np.arange(self.cfg.height) / ry).astype(np.int32),
                out.shape[0] - 1,
            )
            xi = np.minimum(
                (np.arange(self.cfg.width) / rx).astype(np.int32),
                out.shape[1] - 1,
            )
            return out[yi][:, xi]
        out = to_uint8(post_process(self._linear_image(), self.cfg))
        return np.asarray(out)[::-1]

    def _linear_image(self) -> jnp.ndarray:
        """Linear radiance for display/output: the accumulation buffer,
        A-Trous-denoised when enabled (and something is accumulated)."""
        if not self.denoise or self.subframe == 0:
            return self.accum
        if self._aov is None:
            from pathtracer.render.aov import render_aov

            self._aov = render_aov(self.scene, self._cam_arrays, self.cfg)
        from pathtracer.render.aov import atrous_denoise, defocus_mask

        return atrous_denoise(
            self.accum, self._aov,
            defocus=defocus_mask(self._aov, self.cfg),
        )

    def image_hdr(self) -> np.ndarray:
        """Raw linear HDR accumulation (row 0 = top) for EXR output.

        Deliberately NOT denoised even when `denoise` is on: EXR is the
        interchange format for external denoisers/compositors, which need
        the unfiltered accumulation (denoise stays display/PNG-only, like
        checkpoints stay raw)."""
        return np.asarray(self.accum)[::-1]

    def stats(self) -> dict:
        drop = 1 if len(self.frame_times) > 1 else 0  # first carries compile
        times = self.frame_times[drop:]
        paths = self._frame_paths[drop:]
        if not times:
            return {}
        mean_t = float(np.mean(times))
        st = {
            "subframe": self.subframe,
            "spp": self.spp,
            "ms_per_frame": mean_t * 1e3,
            "paths_per_sec": float(np.sum(paths)) / float(np.sum(times)),
        }
        pts = self._pv_times.get(self._pv_scale)
        if pts:
            st["preview_scale"] = self._pv_scale
            st["preview_ms"] = float(sorted(pts[-3:])[len(pts[-3:]) // 2]) * 1e3
        return st

    # -- checkpoint / resume (SURVEY.md §5) --------------------------------
    def _scene_fingerprint(self) -> str:
        """Content hash of the scene's geometry/materials/lighting so a
        resume against a *different* scene (same config) is rejected
        instead of silently blending two renders.  Computed lazily — it
        reads the scene back from the device, and checkpointing already
        pays one readback for the accum buffer."""
        import hashlib

        h = hashlib.sha1()
        for arr in (
            self.scene.vertices,
            self.scene.mat_ids,
            self.scene.materials.attrs,
            self.scene.env.data,
        ):
            a = np.asarray(arr)
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        return h.hexdigest()

    def save_checkpoint(self, path: str) -> None:
        meta = {
            "subframe": self.subframe,
            "accum_spp": self._accum_spp,
            "camera": dataclasses.asdict(self.camera),
            "config": dataclasses.asdict(self.cfg),
            "scene": self._scene_fingerprint(),
            "version": 3,
        }
        np.savez_compressed(
            path,
            accum=np.asarray(self.accum),
            meta=json.dumps(meta),
        )
        plog.info("checkpoint", f"saved {path} @ subframe {self.subframe}")

    def load_checkpoint(self, path: str) -> None:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        data = np.load(path, allow_pickle=False)
        meta = json.loads(str(data["meta"]))
        # JSON roundtrip turns tuples into lists; normalise both sides.
        cfg_d = json.loads(json.dumps(dataclasses.asdict(self.cfg)))
        if meta["config"] != cfg_d:
            diff = {
                k: (meta["config"].get(k), cfg_d[k])
                for k in cfg_d
                if meta["config"].get(k) != cfg_d[k]
            }
            raise ValueError(f"checkpoint config mismatch: {diff}")
        ckpt_scene = meta.get("scene")
        if ckpt_scene is not None and ckpt_scene != self._scene_fingerprint():
            raise ValueError(
                "checkpoint scene mismatch: the checkpoint was rendered "
                "from different geometry/materials/lighting than the "
                "current scene"
            )
        self.accum = jnp.asarray(data["accum"])
        self.subframe = int(meta["subframe"])
        # v2 checkpoints predate the converge ramp: constant-spp history.
        self._accum_spp = int(
            meta.get(
                "accum_spp", self.subframe * self.cfg.samples_per_launch
            )
        )
        cam_meta = meta["camera"]
        self.camera = Camera(
            eye=tuple(cam_meta["eye"]),
            lookat=tuple(cam_meta["lookat"]),
            up=tuple(cam_meta["up"]),
            fov_y=cam_meta["fov_y"],
            aspect=cam_meta["aspect"],
        )
        self._cam_arrays = camera_arrays(self.camera, self.cfg)
        plog.info("checkpoint", f"resumed {path} @ subframe {self.subframe}")
