"""Train CLI -- ``python -m pcp_tpu_torch.cli.train -s <scene> -m <out>
[--device cpu]``.

Counterpart of ``pcp_tpu/cli/train.py`` (reference train.py:245-274, the
same core flags): trains one COLMAP or Blender scene/block (``load_scene``
sniffs the type) and writes <out>/point_cloud/iteration_<N>/point_cloud.ply,
cfg_args.json and train_log.jsonl; ``--checkpoint_iterations`` writes
<out>/chkpnt<N>.pth, which ``--start_checkpoint`` resumes from (JAX's resume:
the camera shuffle and the densify draws restart from ``--seed``).
``--debug`` dumps a non-finite step's inputs and stops; ``--profile`` writes
a ``torch.profiler`` trace under <out>/trace. The SIBR viewer socket listens
on ``--ip``:``--port`` (127.0.0.1:6009; ``--ip none`` or
``--disable_viewer`` turns it off); where it cannot bind, training runs
headless, as in JAX. ``main`` returns the final ``TrainState``.
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
    p.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    p.add_argument("--start_checkpoint", type=str, default=None)
    p.add_argument("--log_interval", type=int, default=100,
                   help="read and log the step's metrics every N iterations")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ip", type=str, default="127.0.0.1",
                   help="viewer socket host (train.py:252); 'none' disables")
    p.add_argument("--port", type=int, default=6009)
    p.add_argument("--disable_viewer", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace under the model dir")
    args = p.parse_args(argv)

    import torch

    from pcp_tpu_torch.device import resolve_device
    from pcp_tpu_torch.scene import load_scene
    from pcp_tpu_torch.train import checkpoint as ckpt
    from pcp_tpu_torch.train.loop import init_state, train_scene
    from pcp_tpu_torch.utils.general import safe_state

    device = resolve_device(args.device)
    cfg = config_from_args(args)
    cfg.test_iterations = args.test_iterations
    cfg.save_iterations = args.save_iterations
    cfg.checkpoint_iterations = args.checkpoint_iterations
    cfg.start_checkpoint = args.start_checkpoint
    cfg.seed = args.seed
    safe_state(args.seed)
    scene = load_scene(cfg.model.source_path, images_dir=cfg.model.images,
                       white_background=cfg.model.white_background,
                       eval_split=cfg.model.eval,
                       man_trans=man_trans_from_config(cfg.model))
    log_fn = None if args.quiet else print
    if log_fn:
        log_fn(f"training {cfg.model.source_path} on {device}: "
               f"{len(scene.cameras)} cameras, {len(scene.points)} points, "
               f"extent {scene.extent:.2f}")
    state = None
    start_iter = 0
    if cfg.start_checkpoint:
        template = init_state(scene, cfg,
                              torch.Generator().manual_seed(cfg.seed), device)
        state, start_iter = ckpt.load(cfg.start_checkpoint, template)
        if log_fn:
            log_fn(f"resumed from {cfg.start_checkpoint} @ iter {start_iter}")
    viewer = None
    if not args.disable_viewer and args.ip != "none":
        from pcp_tpu_torch.viewer import NetworkGUI

        try:
            viewer = NetworkGUI(args.ip, args.port)
        except OSError as e:
            print(f"viewer socket unavailable ({e}); continuing headless")
    try:
        state = train_scene(scene, cfg, log_fn=log_fn, state=state,
                            start_iter=start_iter,
                            log_interval=args.log_interval,
                            profile=args.profile, viewer=viewer,
                            device=device)
    finally:
        if viewer is not None:
            viewer.close()
    if log_fn:
        log_fn(f"training complete: {cfg.model.model_path}")
    return state


if __name__ == "__main__":
    main()
