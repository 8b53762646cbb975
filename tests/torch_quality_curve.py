"""Whether the port and the JAX package train one block to the same quality
on the CPU (ROADMAP C2): not a tier-1 test, a script run by hand.

    JAX_PLATFORMS=cpu python -m tests.torch_quality_curve [--iters 2000]

Writes one small scene with ``tests/synthetic.py`` (150 points, 12 cameras
at 64x48, every 4th held out), then trains it with ``pcp_tpu.cli.train``
(JAX on the CPU) and ``pcp_tpu_torch.cli.train --device cpu`` side by side
in two processes, with the same flags on the quality tools' cadence scaled
down: 2048 slots, appearance on, densify every 100 from 500 to 75% of the
run, an opacity reset at 1000. Every saved snapshot of both runs is scored
by one scorer, the port's render and ``evaluate_images`` on the CPU
(colour-corrected PSNR and SSIM over the held-out views), so the two
columns differ only by training. Prints one line per snapshot (PSNR, SSIM
and alive count of both packages) and, last, one JSON object with the
table and each run's wall seconds. Both runs together take about 15
minutes on an 8-core host.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from tests.synthetic import write_synthetic_scene

SNAPSHOTS = (250, 500, 750, 1000, 1250, 1500, 2000)
LLFFHOLD = 4


def _flags(scene: str, out: str, iters: int) -> list:
    saves = [str(i) for i in SNAPSHOTS if i < iters] + [str(iters)]
    return ["-s", scene, "-m", out, "--iterations", str(iters),
            "--eval", "--llffhold", str(LLFFHOLD), "--resolution", "1",
            "--capacity", "2048", "--max_per_tile", "512",
            "--densify_from_iter", "500", "--densification_interval", "100",
            "--densify_until_iter", str(int(0.75 * iters)),
            "--opacity_reset_interval", "1000",
            "--test_iterations", "0", "--save_iterations", *saves,
            "--seed", "0", "--disable_viewer", "--quiet"]


def _score(scene: str, out: str) -> dict:
    """{iteration: (PSNR, SSIM, alive)} of every snapshot under ``out``."""
    import torch

    from pcp_tpu_torch.eval.metrics import evaluate_images
    from pcp_tpu_torch.eval.render_batch import render_view
    from pcp_tpu_torch.io.ply import read_ply
    from pcp_tpu_torch.models import gaussians as G
    from pcp_tpu_torch.scene import cameras as cam_mod
    from pcp_tpu_torch.scene import load_colmap_scene, split_train_test

    test = [cam_mod.from_info(i, 1) for i in split_train_test(
        load_colmap_scene(scene).cameras, True, LLFFHOLD)[1]]
    bg = torch.zeros(3)
    rows = {}
    for d in os.listdir(os.path.join(out, "point_cloud")):
        it = int(d[len("iteration_"):])
        ply = os.path.join(out, "point_cloud", d, "point_cloud.ply")
        n = len(read_ply(ply)["x"])
        params, alive = G.load_gaussians_ply(
            ply, G.GaussianConfig(sh_degree=3, capacity=n), "cpu")
        renders = [render_view(params, alive, c, 3, bg, device="cpu")[0]
                   for c in test]
        m = evaluate_images(renders, [c.gt_image for c in test],
                            device="cpu")["mean"]
        rows[it] = (m["PSNR"], m["SSIM"], n)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=2000)
    args = ap.parse_args(argv)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PCP_TENSORBOARD="0",
               OMP_NUM_THREADS="4")
    with tempfile.TemporaryDirectory() as d:
        scene = os.path.join(d, "scene")
        write_synthetic_scene(scene, np.random.default_rng(21),
                              n_points=150, n_cams=12, W=64, H=48)
        runs = {"jax": "pcp_tpu.cli.train", "port": "pcp_tpu_torch.cli.train"}
        procs, t0 = {}, time.time()
        for name, mod in runs.items():
            extra = ["--device", "cpu"] if name == "port" else []
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", mod,
                 *_flags(scene, os.path.join(d, name), args.iters), *extra],
                env=env)
        wall = {}
        while len(wall) < len(procs):
            for name, p in procs.items():
                if name not in wall and p.poll() is not None:
                    if p.returncode != 0:
                        raise RuntimeError(
                            f"{name} training failed: rc {p.returncode}")
                    wall[name] = time.time() - t0
            time.sleep(1.0)
        scores = {name: _score(scene, os.path.join(d, name)) for name in runs}
    table = []
    for it in sorted(scores["jax"]):
        (jp, js, jn), (tp, ts, tn) = scores["jax"][it], scores["port"][it]
        table.append({"iter": it, "jax": {"PSNR": jp, "SSIM": js, "alive": jn},
                      "port": {"PSNR": tp, "SSIM": ts, "alive": tn}})
        print(f"iter {it:5d}: PSNR jax {jp:.3f} port {tp:.3f} "
              f"(port - jax {tp - jp:+.3f} dB), SSIM jax {js:.4f} port "
              f"{ts:.4f}, alive jax {jn} port {tn}", flush=True)
    out = {"iters": args.iters, "wall_s": wall, "table": table}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
