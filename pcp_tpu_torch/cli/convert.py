"""COLMAP SfM runner — `python -m pcp_tpu_torch.cli.convert -s <dir>`.

Reference: convert.py:18-124 — run colmap feature_extractor /
exhaustive_matcher / mapper / image_undistorter over <dir>/input images to
produce the expected {images/, sparse/0/} layout, with optional 2x/4x/8x
resized copies. Requires the `colmap` (and optionally ImageMagick `magick`)
executables on PATH; this tool only orchestrates them.

Counterpart of ``pcp_tpu/cli/convert.py``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def _run(cmd: str) -> None:
    print("+", cmd)
    rc = subprocess.call(cmd, shell=True)
    if rc != 0:
        print(f"command failed ({rc}): {cmd}", file=sys.stderr)
        raise SystemExit(rc)


def main(argv=None) -> None:
    from pcp_tpu_torch.cli.common import add_device_arg

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-s", "--source_path", required=True)
    p.add_argument("--no_gpu", action="store_true")
    p.add_argument("--skip_matching", action="store_true")
    p.add_argument("--camera", default="OPENCV")
    p.add_argument("--colmap_executable", default="colmap")
    p.add_argument("--resize", action="store_true")
    p.add_argument("--magick_executable", default="magick")
    add_device_arg(p)
    args = p.parse_args(argv)

    from pcp_tpu_torch.device import resolve_device

    # a host tool: the flag keeps the port's device rule
    resolve_device(args.device)

    colmap = args.colmap_executable
    src = args.source_path
    use_gpu = 0 if args.no_gpu else 1

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted", "sparse"), exist_ok=True)
        _run(
            f"{colmap} feature_extractor"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            f" --ImageReader.single_camera 1"
            f" --ImageReader.camera_model {args.camera}"
            f" --SiftExtraction.use_gpu {use_gpu}"
        )
        _run(
            f"{colmap} exhaustive_matcher"
            f" --database_path {src}/distorted/database.db"
            f" --SiftMatching.use_gpu {use_gpu}"
        )
        _run(
            f"{colmap} mapper"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            f" --output_path {src}/distorted/sparse"
            f" --Mapper.ba_global_function_tolerance=0.000001"
        )

    _run(
        f"{colmap} image_undistorter"
        f" --image_path {src}/input"
        f" --input_path {src}/distorted/sparse/0"
        f" --output_path {src}"
        f" --output_type COLMAP"
    )
    # move sparse/* -> sparse/0 (convert.py:76-87)
    sparse = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f == "0":
            continue
        shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))

    if args.resize:  # convert.py:89-124
        for factor, pct in ((2, 50), (4, 25), (8, 12.5)):
            out = os.path.join(src, f"images_{factor}")
            os.makedirs(out, exist_ok=True)
            for fn in os.listdir(os.path.join(src, "images")):
                dst = os.path.join(out, fn)
                shutil.copy2(os.path.join(src, "images", fn), dst)
                _run(f"{args.magick_executable} mogrify -resize {pct}% {dst}")
    print("Done.")


if __name__ == "__main__":
    main()
