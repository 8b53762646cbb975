"""Benchmark harness — ``python -m pcp_tpu_torch.cli.full_eval [...]
[--device cpu]``.

Counterpart of ``pcp_tpu/cli/full_eval.py`` (reference full_eval.py:15-75):
the upstream 3DGS benchmark scene lists (MipNeRF-360, Tanks&Temples,
DeepBlending) through train -> render -> metrics, with the same flags. The
port's CLIs run in-process and each gets ``--device``. ``main`` returns
what ``cli.metrics`` returns (empty with ``--skip_metrics``).
"""

from __future__ import annotations

import argparse
import os

MIPNERF360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
MIPNERF360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TANKS_AND_TEMPLES = ["truck", "train"]
DEEP_BLENDING = ["drjohnson", "playroom"]


def main(argv=None):
    from pcp_tpu_torch.cli.common import add_device_arg

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output_path", default="./eval")
    p.add_argument("--mipnerf360", default="")
    p.add_argument("--tanksandtemples", default="")
    p.add_argument("--deepblending", default="")
    p.add_argument("--skip_training", action="store_true")
    p.add_argument("--skip_rendering", action="store_true")
    p.add_argument("--skip_metrics", action="store_true")
    p.add_argument("--iterations", type=int, default=30_000)
    add_device_arg(p)
    args = p.parse_args(argv)

    from pcp_tpu_torch.cli import metrics as metrics_cli
    from pcp_tpu_torch.cli import render as render_cli
    from pcp_tpu_torch.cli import train as train_cli

    jobs = []
    if args.mipnerf360:
        for s in MIPNERF360_OUTDOOR:
            jobs.append((os.path.join(args.mipnerf360, s), ["-i", "images_4"]))
        for s in MIPNERF360_INDOOR:
            jobs.append((os.path.join(args.mipnerf360, s), ["-i", "images_2"]))
    if args.tanksandtemples:
        jobs += [(os.path.join(args.tanksandtemples, s), [])
                 for s in TANKS_AND_TEMPLES]
    if args.deepblending:
        jobs += [(os.path.join(args.deepblending, s), [])
                 for s in DEEP_BLENDING]
    if not jobs:
        p.error("give at least one of --mipnerf360/--tanksandtemples/"
                "--deepblending")

    dev = ["--device", args.device]
    model_paths = []
    for src, extra in jobs:
        name = os.path.basename(src.rstrip("/"))
        out = os.path.join(args.output_path, name)
        model_paths.append(out)
        if not args.skip_training:
            train_cli.main(
                ["-s", src, "-m", out, "--eval", "--quiet",
                 "--iterations", str(args.iterations),
                 "--test_iterations", str(args.iterations),
                 "--save_iterations", str(args.iterations)] + extra + dev
            )
        if not args.skip_rendering:
            render_cli.main(["-s", src, "-m", out,
                             "--iteration", str(args.iterations)]
                            + extra + dev)
    if args.skip_metrics:
        return {}
    return metrics_cli.main(["-m"] + model_paths + dev)


if __name__ == "__main__":
    main()
