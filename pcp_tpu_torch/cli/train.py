"""Train CLI -- ``python -m pcp_tpu_torch.cli.train -s <scene> -m <out>
[--device cpu]``.

Counterpart of ``pcp_tpu/cli/train.py`` (reference train.py:245-274, the
same core flags): trains one COLMAP scene/block and writes
<out>/point_cloud/iteration_<N>/point_cloud.ply, cfg_args.json and
train_log.jsonl. ``main`` returns the final ``TrainState``. Checkpoint
resume and the viewer flags come with those modules.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from pcp_tpu_torch.cli.common import (
        add_device_arg,
        add_model_args,
        add_optim_args,
        add_pipeline_args,
        config_from_args,
        man_trans_from_config,
    )

    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    add_optim_args(p)
    add_pipeline_args(p)
    add_device_arg(p)
    p.add_argument("--test_iterations", nargs="+", type=int,
                   default=[7_000, 30_000])
    p.add_argument("--save_iterations", nargs="+", type=int,
                   default=[7_000, 30_000])
    p.add_argument("--log_interval", type=int, default=100,
                   help="read and log the step's metrics every N iterations")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from pcp_tpu_torch.device import resolve_device
    from pcp_tpu_torch.scene import load_colmap_scene
    from pcp_tpu_torch.train.loop import train_scene

    device = resolve_device(args.device)
    cfg = config_from_args(args)
    cfg.test_iterations = args.test_iterations
    cfg.save_iterations = args.save_iterations
    cfg.seed = args.seed
    scene = load_colmap_scene(cfg.model.source_path,
                              images_dir=cfg.model.images,
                              man_trans=man_trans_from_config(cfg.model))
    log_fn = None if args.quiet else print
    if log_fn:
        log_fn(f"training {cfg.model.source_path} on {device}: "
               f"{len(scene.cameras)} cameras, {len(scene.points)} points, "
               f"extent {scene.extent:.2f}")
    state = train_scene(scene, cfg, log_fn=log_fn,
                        log_interval=args.log_interval, device=device)
    if log_fn:
        log_fn(f"training complete: {cfg.model.model_path}")
    return state


if __name__ == "__main__":
    main()
