"""The ``render`` traffic kind: one client renders a merged scene's
held-out views in turn, each through the port's
``eval/render_batch.render_view`` (the image comes back to the host), in a
closed loop. Every view is timed from its call to the image on the host.
Once the window has closed and the scene is freed, the plain reference
renders a sample of the views, drawn from the seed, and the last image the
window returned for each is compared with it.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from gpubench import compare, roofline, scene, trace
from gpubench.reference import render as ref_render

# render_view's clamp of a tile's list: none, as the configurations train
NO_CLAMP = 1 << 30


class Scene:
    """The inputs of one seed: the merged scene's Gaussians and the rig's
    held-out views."""

    def __init__(self, cfg: Dict, seed: int, device):
        self.cfg, self.seed, self.dev = cfg, seed, torch.device(device)
        rig = cfg["scene"]["rig"]
        _, self.views = scene.split_views(scene.views(cfg, rig),
                                          int(rig["hold"]))
        self.background = torch.zeros(3, device=self.dev)

    def gaussians(self):
        return scene.gaussians(dict(self.cfg["scene"],
                                    sh_degree=self.cfg["sh_degree"]),
                               self.seed, self.dev)


def reference_image(sc: Scene, view, counts: bool = False):
    """The reference's clipped image of ``view`` (and the blend's work)."""
    p, alive = sc.gaussians()
    out = ref_render.render_params({k: v[alive] for k, v in p.items()},
                                   view, int(sc.cfg["sh_degree"]),
                                   sc.background, counts=counts)
    img = torch.clamp(out[0], 0.0, 1.0).cpu().numpy()
    if counts:
        out[2]["live"] = int(alive.sum())
        return img, out[2]
    return img


def run(cfg: Dict, traffic: Dict, seed: int, seconds: float, traced: bool,
        device, t_start: float) -> Dict:
    from pcp_tpu_torch.eval.render_batch import render_view
    from pcp_tpu_torch.scene.cameras import Camera

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    sc = Scene(cfg, seed, dev)
    params, alive = sc.gaussians()
    cams = [Camera(uid=v.uid, viewmat=v.viewmat, fx=v.fx, fy=v.fy,
                   width=v.width, height=v.height) for v in sc.views]
    order = scene.camera_order(seed, len(cams),
                               int(traffic.get("max_window_views", 100_000)))
    sh = int(cfg["sh_degree"])

    def one(cam):
        return render_view(params, alive, cam, sh, sc.background,
                           max_per_tile=NO_CLAMP, device=dev)[0]

    for cam in cams:                  # every shape the window will use
        one(cam)
    sync()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    profile_at = range(int(traffic["profile_offset"]),
                       int(traffic["profile_offset"])
                       + int(traffic["profile_views"])) if traced else ()
    lat, last, parts, profiled = [], {}, [], []
    t_setup = time.perf_counter() - t_start
    t0 = time.perf_counter()
    while len(lat) < len(order):
        i = order[len(lat)]
        if len(lat) in profile_at:
            with torch.profiler.profile(activities=trace.ACTIVITIES) as prof:
                sync()
                tp = time.perf_counter()
                img = one(cams[i])
                wall = time.perf_counter() - tp
            parts.append(trace.reduce(prof, 1, wall))
            profiled.append(i)
            lat.append(wall)
        else:
            tq = time.perf_counter()
            img = one(cams[i])
            lat.append(time.perf_counter() - tq)
        last[i] = img
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    lat_ms = [1e3 * x for x in lat]
    result = {
        "attempted": len(lat), "failed": 0, "memory_peak_bytes": int(peak),
        "window_s": window_s,
        "end_to_end": {"setup_s": t_setup,
                       "render_ms_p95": float(np.percentile(lat_ms, 95)),
                       "render_views_per_s": len(lat) / window_s},
    }
    del params, alive
    if on_card:
        torch.cuda.empty_cache()

    if traced:
        t = trace.merge(parts)
        ideal: Dict[str, float] = {}
        counts = []
        for i in profiled:
            c = reference_image(sc, sc.views[i], counts=True)[1]
            counts.append(c)
            for k, v in roofline.render_stages(c["live"], c, sh).items():
                ideal[k] = ideal.get(k, 0.0) + v / len(profiled)
        plain = [x for k, x in enumerate(lat_ms) if k not in profile_at]
        t.update(kind="render", ideal_ms=ideal, counts=counts,
                 step_ms_untraced=sum(plain) / max(len(plain), 1))
        result["trace"] = t

    rng = np.random.default_rng(int(seed) % (1 << 63))
    seen = sorted(last)
    sample = rng.choice(seen, size=min(int(traffic["check_views"]),
                                       len(seen)), replace=False)
    gaps = [compare.image_gaps(last[int(i)],
                               reference_image(sc, sc.views[int(i)]))
            for i in sample]
    result["values"] = {"image_mean_gap": max(g["mean"] for g in gaps)}
    result["notes"] = {"image_max_gap": max(g["max"] for g in gaps),
                       "views_checked": [int(i) for i in sample]}
    return result
