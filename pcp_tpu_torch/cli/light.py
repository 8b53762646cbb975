"""Low-light image filter — `python -m pcp_tpu_torch.cli.light <image_dir>`.

Reference: light.py:5-65 — per-image mean brightness in grayscale and HSV-V,
threshold = mean - stddev over the directory, write
low_light_images_{gray,hsv}.txt listing the dark images.

Counterpart of ``pcp_tpu/cli/light.py``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def analyze_directory(image_dir: str):
    import cv2

    names, gray_means, hsv_means = [], [], []
    for fn in sorted(os.listdir(image_dir)):
        if not fn.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        img = cv2.imread(os.path.join(image_dir, fn))
        if img is None:
            continue
        names.append(fn)
        gray_means.append(float(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY).mean()))
        hsv_means.append(
            float(cv2.cvtColor(img, cv2.COLOR_BGR2HSV)[..., 2].mean())
        )
    gray = np.asarray(gray_means)
    hsv = np.asarray(hsv_means)
    out = {}
    for tag, vals in (("gray", gray), ("hsv", hsv)):
        thr = vals.mean() - vals.std()
        low = [n for n, v in zip(names, vals) if v < thr]
        out[tag] = (thr, low)
        with open(
            os.path.join(image_dir, f"low_light_images_{tag}.txt"), "w"
        ) as f:
            f.write("\n".join(low))
    return out


def main(argv=None) -> None:
    from pcp_tpu_torch.cli.common import add_device_arg

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("image_dir")
    add_device_arg(p)
    args = p.parse_args(argv)

    from pcp_tpu_torch.device import resolve_device

    # a host tool: the flag keeps the port's device rule
    resolve_device(args.device)
    out = analyze_directory(args.image_dir)
    for tag, (thr, low) in out.items():
        print(f"{tag}: threshold {thr:.1f}, {len(low)} low-light images")


if __name__ == "__main__":
    main()
