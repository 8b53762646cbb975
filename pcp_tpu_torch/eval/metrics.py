"""Color-corrected PSNR / SSIM / LPIPS over render/GT pairs (counterpart of
``pcp_tpu/eval/metrics.py``; metrics.py:29-186 ``evaluate_single`` of the
reference).

Each view goes to the device once; the color correction, PSNR, SSIM and
LPIPS run there and only the three numbers and the corrected image (for
``renders_cc/``) come back. The JAX package recomputes an SSIM that falls
outside [-1, 1] on fresh buffers: that answered a stale-buffer fault of its
TPU runtime and has no counterpart here, so such a value raises instead.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from pcp_tpu_torch.device import DeviceLike, resolve_device
from pcp_tpu_torch.eval.lpips import make_lpips
from pcp_tpu_torch.utils.image import color_correct, psnr
from pcp_tpu_torch.utils.loss import ssim


def _load_image(path: str) -> np.ndarray:
    from PIL import Image as PILImage

    return np.asarray(PILImage.open(path).convert("RGB"), np.float32) / 255.0


def evaluate_images(
    renders: List[np.ndarray],
    gts: List[np.ndarray],
    names: Optional[List[str]] = None,
    *,
    use_color_correct: bool = True,
    lpips_weights: Optional[str] = None,
    save_cc_dir: Optional[str] = None,
    device: DeviceLike = None,
) -> Dict:
    """{"mean": {...}, "per_view": {name: {"PSNR", "SSIM", "LPIPS"}}} over
    (H, W, 3) float images in [0, 1], on ``device`` (the card unless
    ``"cpu"``); LPIPS is None without weights."""
    dev = resolve_device(device)
    names = names or [f"{i:05d}.png" for i in range(len(renders))]
    lpips_fn = make_lpips(lpips_weights, dev)
    rows = {}
    with torch.no_grad():
        for name, render, gt in zip(names, renders, gts):
            r = torch.as_tensor(np.asarray(render, np.float32), device=dev)
            g = torch.as_tensor(np.asarray(gt, np.float32), device=dev)
            rc = (torch.clamp(color_correct(r, g), 0.0, 1.0)
                  if use_color_correct else r)
            if save_cc_dir:
                from PIL import Image as PILImage

                os.makedirs(save_cc_dir, exist_ok=True)
                PILImage.fromarray(
                    (rc.cpu().numpy() * 255).astype(np.uint8)
                ).save(os.path.join(save_cc_dir, name))
            s = float(ssim(rc.permute(2, 0, 1), g.permute(2, 0, 1)))
            if not -1.0 <= s <= 1.0001:
                raise RuntimeError(f"SSIM {s} of {name} is outside [-1, 1]")
            rows[name] = {
                "PSNR": float(psnr(rc[None], g[None])[0]),
                "SSIM": s,
                "LPIPS": float(lpips_fn(rc, g)) if lpips_fn else None,
            }
    mean = {}
    for k in ("PSNR", "SSIM", "LPIPS"):
        vals = [v[k] for v in rows.values() if v[k] is not None]
        mean[k] = float(np.mean(vals)) if vals else None
    return {"mean": mean, "per_view": rows}


def evaluate_dir(
    method_dir: str,
    *,
    use_color_correct: bool = True,
    lpips_weights: Optional[str] = None,
    device: DeviceLike = None,
) -> Dict:
    """Evaluate <method_dir>/{renders,gt}/ and write renders_cc/,
    results.json and per_view.json beside them (metrics.py:58,108-111)."""
    rdir = os.path.join(method_dir, "renders")
    gdir = os.path.join(method_dir, "gt")
    names = sorted(f for f in os.listdir(rdir)
                   if f.lower().endswith((".png", ".jpg")))
    renders = [_load_image(os.path.join(rdir, f)) for f in names]
    gts = [_load_image(os.path.join(gdir, f)) for f in names]
    out = evaluate_images(
        renders, gts, names,
        use_color_correct=use_color_correct,
        lpips_weights=lpips_weights,
        save_cc_dir=(os.path.join(method_dir, "renders_cc")
                     if use_color_correct else None),
        device=device,
    )
    with open(os.path.join(method_dir, "results.json"), "w") as f:
        json.dump(out["mean"], f, indent=2)
    with open(os.path.join(method_dir, "per_view.json"), "w") as f:
        json.dump(out["per_view"], f, indent=2)
    return out
