"""Training-quality check on the card (counterpart of
``tools/tpu_train_check.py``): train the synthetic scene a few hundred
iterations through the port's kernels and check that PSNR climbs.

    python -m pcp_tpu_torch.tools.train_check [--device cpu]

The scene is ``default_rng(0)``'s 120 points and 10 cameras at 64x48; 400
iterations in 256 slots, densify every 100 from 100 to 300, appearance
off. PSNR on the first 2 cameras before and after must rise by more than
2 dB and end above 19 dB (the JAX tool's bar); the exit code is 1
otherwise. It runs on the card and raises without one; ``--device cpu`` is
for the tests.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

ITERATIONS = 400
N_POINTS, N_CAMS = 120, 10
EVAL_CAMS = 2                  # scored before and after training
GAIN_DB, FLOOR_DB = 2.0, 19.0


def run(device=None) -> dict:
    """{"before", "after": PSNR dB, "ok": the bar held, "device"}."""
    from pcp_tpu_torch.device import resolve_device
    from pcp_tpu_torch.scene import cameras as cam_mod
    from pcp_tpu_torch.scene import load_colmap_scene
    from pcp_tpu_torch.tools.synthetic import write_synthetic_scene
    from pcp_tpu_torch.train.config import (
        ModelConfig,
        OptimConfig,
        PipelineConfig,
        TrainRunConfig,
    )
    from pcp_tpu_torch.train.loop import (
        evaluate_cameras,
        init_state,
        train_scene,
    )

    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as td:
        scene_dir = td + "/scene"
        write_synthetic_scene(scene_dir, np.random.default_rng(0),
                              n_points=N_POINTS, n_cams=N_CAMS,
                              device=dev)
        scene = load_colmap_scene(scene_dir)
        cfg = TrainRunConfig(
            model=ModelConfig(source_path=scene_dir, model_path=td + "/out",
                              resolution=1, sh_degree=3),
            optim=OptimConfig(iterations=ITERATIONS, capacity=256,
                              max_per_tile=128, densify_from_iter=100,
                              densification_interval=100,
                              opacity_reset_interval=10_000,
                              densify_until_iter=300),
            pipeline=PipelineConfig(use_appearance=False),
            test_iterations=[], save_iterations=[],
        )
        cams = [cam_mod.from_info(i, 1) for i in scene.cameras]
        bg = torch.zeros(3, device=dev)
        state0 = init_state(scene, cfg, torch.Generator().manual_seed(0),
                            dev)
        before = evaluate_cameras(state0, cams[:EVAL_CAMS], 0, bg,
                                  cfg.optim)
        state = train_scene(scene, cfg, log_fn=None, device=dev)
        after = evaluate_cameras(state, cams[:EVAL_CAMS], 3, bg, cfg.optim)
    ok = (after["psnr"] > before["psnr"] + GAIN_DB
          and after["psnr"] > FLOOR_DB)
    return {"before": before["psnr"], "after": after["psnr"], "ok": ok,
            "device": str(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    r = run(args.device)
    print(f"PSNR {r['before']:.2f} -> {r['after']:.2f} on {r['device']} "
          f"(bar: +{GAIN_DB} dB and > {FLOOR_DB} dB)")
    print("TRAIN QUALITY OK" if r["ok"] else "TRAIN QUALITY FAIL")
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
