"""Full-schedule quality proof at small scale (counterpart of
``tools/quality_run.py``; the reference-operating-point companion is
``quality_scale_run``).

    python -m pcp_tpu_torch.tools.quality_run [--scene DIR] [--iters N]
        [--app_iters N] [--skip_densify_pair] [--skip_appearance_pair]
        [--device cpu]

Drives the production workflow end to end through the port's CLIs:

    partition -> auto_train (--sequential; densify on up to a 2^16-slot
    cap, appearance on, 10k iterations a block) -> merge -> render ->
    metrics (LPIPS from a synthetic-weights bundle, labelled)

on a synthetic scene whose GT is rendered from a known Gaussian set
(``tools.synthetic``), beside a no-densify control at the same budget;
then an appearance A/B/C on the same scene with per-view exposure,
white-balance and vignette jitter on the training views: a shared
appearance (the fleet, ``--share_appearance``), per-block appearance on,
and off. The artifact (``QR_OUT``, default ``QUALITY_torch_small.json`` at
the repo root) holds every variant's PSNR/SSIM/LPIPS, the merged scene's
scores at each earlier iteration where every block saved a PLY (the CLI's
save iterations: 7000 of a 10k run), the blocks' summed population every
1000 steps with the mean step ms, and the card's name and power limit; a
``--skip_*`` rerun replaces only its own variants in it; it is rewritten
after every variant. Scene directories are reused when they exist.
``QR_W``, ``QR_H``,
``QR_PTS``, ``QR_CAMS``, ``QR_CAP`` and ``QR_THRESHOLD`` shrink the run.
Everything runs on the card and raises without one; ``--device cpu``
runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORK = os.path.join(REPO, "_quality")      # scenes and models; gitignored

W = int(os.environ.get("QR_W", "400"))
H = int(os.environ.get("QR_H", "304"))
N_POINTS = int(os.environ.get("QR_PTS", "4000"))
N_CAMS = int(os.environ.get("QR_CAMS", "48"))
ITERS = 10_000
CAPACITY = int(os.environ.get("QR_CAP", str(1 << 16)))
LLFFHOLD = 8
THRESHOLD = int(os.environ.get("QR_THRESHOLD", "1500"))
ARTIFACT = os.environ.get("QR_OUT", "QUALITY_torch_small.json")
LPIPS_NOTE = ("synthetic (plumbing stand-in; values not comparable to "
              "published LPIPS)")


def card_of(device: str):
    """``nvidia-smi``'s "name, power.limit" of the card, or None on the
    CPU."""
    if device == "cpu":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def lpips_weights_path(scene_dir: str) -> str:
    """The synthetic LPIPS bundle (no pretrained weights can be fetched;
    labelled in the artifact)."""
    p = os.path.join(scene_dir, "lpips_synth.npz")
    if not os.path.exists(p):
        from pcp_tpu_torch.eval.lpips import synthetic_weights

        np.savez(p, **synthetic_weights(0))
    return p


def _block_out(visible: str, bid: str) -> str:
    return os.path.join(visible, bid, f"partition_{bid}", "output")


def _common_snapshots(visible: str, blocks, iters: int) -> list:
    """Iterations below ``iters`` at which every block saved a PLY."""
    its = None
    for bid in blocks:
        root = os.path.join(_block_out(visible, bid), "point_cloud")
        got = {int(d[len("iteration_"):]) for d in os.listdir(root)}
        its = got if its is None else its & got
    return sorted(i for i in its or () if i < iters)


def _population_curve(visible: str, blocks) -> list:
    """Every 1000 steps: ``total_points`` summed over the blocks' logs
    (alive Gaussians; the fleet logs its visible count there) and the mean
    step ms where the log has it (the sequential loop's ``iter_time``)."""
    from pcp_tpu_torch.train.logging import every, read_log

    by_iter = {}
    for bid in blocks:
        for it, r in every(read_log(_block_out(visible, bid))).items():
            by_iter.setdefault(it, {})[bid] = r
    curve = []
    for it in sorted(by_iter):
        rows = by_iter[it].values()
        times = [r["iter_time"] for r in rows if "iter_time" in r]
        curve.append({
            "iter": it, "total_points": int(sum(r["total_points"]
                                                for r in rows)),
            "step_ms": (round(1000 * float(np.mean(times)), 2) if times
                        else None)})
    return curve


def run_variant(scene_dir, name, iters, densify: bool, device: str,
                appearance: bool = True, share_appearance: bool = False):
    from pcp_tpu_torch.cli import auto_train, merge, metrics, render

    t0 = time.time()
    dev = ["--device", device]
    model_dir = os.path.join(scene_dir, "model")
    visible = os.path.join(model_dir, "split_result", "visible")
    densify_args = (
        ["--densify_from_iter", "500", "--densification_interval", "100",
         "--densify_until_iter", str(int(iters * 0.75)),
         "--opacity_reset_interval", "3000"]
        if densify else
        ["--densify_from_iter", str(10 * iters)]
    )
    # a shared appearance exists only on the fleet path; the per-block
    # variants are the reference's independent processes (--sequential)
    mode_args = (["--share_appearance"] if share_appearance
                 else ["--sequential"])
    auto_train.main([
        "--base_path", visible, *mode_args,
        "--iterations", str(iters),
        "--capacity", str(CAPACITY), "--max_per_tile", "512",
        "--resolution", "1",
        *densify_args,
        *([] if appearance else ["--no_appearance"]),
        *dev,
    ])
    with open(os.path.join(visible, "train_status.json")) as f:
        manifest = json.load(f)
    if not all(v["status"] == "done" for v in manifest.values()):
        raise RuntimeError(f"{name}: a block did not finish: {manifest}")

    # the merged scene at every earlier iteration where each block saved a
    # PLY (the CLI's save iterations), then the final one: one metrics
    # call scores them all
    snaps = _common_snapshots(visible, manifest, iters)
    for it in snaps:
        snap_dir = os.path.join(model_dir, "point_cloud", f"iteration_{it}")
        os.makedirs(snap_dir, exist_ok=True)
        merge.main(["-m", model_dir, "--iteration", str(it), "-o",
                    os.path.join(snap_dir, "point_cloud.ply"), *dev])
        render.main(["-s", scene_dir, "-m", model_dir, "--resolution", "1",
                     "--llffhold", str(LLFFHOLD), "--iteration", str(it),
                     *dev])
    merge.main(["-m", model_dir, *dev])
    render.main(["-s", scene_dir, "-m", model_dir, "--resolution", "1",
                 "--llffhold", str(LLFFHOLD), *dev])
    metrics.main(["-m", model_dir,
                  "--lpips_weights", lpips_weights_path(scene_dir), *dev])

    def scores(tag):
        with open(os.path.join(model_dir, "test", f"ours_{tag}",
                               "results.json")) as f:
            return json.load(f)

    results = scores("merged")
    out = {
        "variant": name,
        "iterations": iters,
        "densify": densify,
        "appearance": appearance,
        "PSNR": results["PSNR"],
        "SSIM": results["SSIM"],
        "LPIPS": results.get("LPIPS"),
        "lpips_weights": LPIPS_NOTE,
        "wall_minutes": round((time.time() - t0) / 60.0, 1),
        "blocks": len(manifest),
        "snapshot_curve": [{"iter": it, "PSNR": scores(it)["PSNR"],
                            "SSIM": scores(it)["SSIM"]} for it in snaps],
        "population_curve": _population_curve(visible, manifest),
    }
    # keep the model aside so the next variant starts clean
    kept = os.path.join(scene_dir, f"model_{name}")
    if os.path.isdir(kept):
        shutil.rmtree(kept)
    shutil.move(model_dir, kept)
    return out


def _partition(scene: str, device: str) -> None:
    from pcp_tpu_torch.cli import partition

    # a fresh partition per variant (auto_train writes into the blocks)
    model_dir = os.path.join(scene, "model")
    if os.path.isdir(model_dir):
        shutil.rmtree(model_dir)
    # expansion 6 puts the radius-5 orbit cameras inside the extended
    # boxes (centre-in-box assignment); visible_rate then trims each
    # block's cameras
    partition.main([
        scene, "--threshold", str(THRESHOLD), "--expansion_distance", "6",
        "--visible_rate", "0.25", "--no_plots",
        "--llffhold", str(LLFFHOLD), "--device", device,
    ])


def artifact(card, device: str, iters: int, app_iters: int,
             runs: list) -> dict:
    return {
        "card": card,
        "device": device,
        "workload": {
            "scene": f"synthetic {N_POINTS} pts, {N_CAMS} cams, {W}x{H}",
            "schedule": f"{iters} iters/block, densify 500..75% "
                        f"every 100, opacity reset 3000, appearance ON, "
                        f"capacity {CAPACITY}",
            "appearance_ab": f"same scene + per-view exposure/WB jitter "
                             f"0.45 + per-view-strength vignette (<=0.6 "
                             f"corner falloff) on TRAIN views; held-out "
                             f"views stay clean, {app_iters} iters, "
                             f"appearance shared vs on vs off, "
                             f"color-corrected metrics",
        },
        "runs": runs,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default=os.path.join(WORK, "quality_scene"))
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--app_iters", type=int, default=6000,
                    help="iterations for the appearance-jitter variants")
    ap.add_argument("--skip_densify_pair", action="store_true")
    ap.add_argument("--skip_appearance_pair", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from pcp_tpu_torch.device import resolve_device
    from pcp_tpu_torch.tools.synthetic import write_synthetic_scene

    resolve_device(args.device)
    card = card_of(args.device)
    scene = args.scene
    if not os.path.isdir(os.path.join(scene, "sparse")):
        os.makedirs(scene, exist_ok=True)
        write_synthetic_scene(
            scene, np.random.default_rng(11), n_points=N_POINTS,
            n_cams=N_CAMS, W=W, H=H, device=args.device)
        print(f"scene written: {scene}")

    # a --skip_* rerun refreshes only its own variants and keeps the rest;
    # the artifact is rewritten after every variant, so a run that is cut
    # keeps the variants it finished
    art = os.path.join(REPO, ARTIFACT)
    prev = []
    if os.path.exists(art) and (args.skip_densify_pair
                                or args.skip_appearance_pair):
        with open(art) as f:
            prev = json.load(f).get("runs", [])
    rows = []

    def record(row=None) -> dict:
        if row is not None:
            rows.append(row)
            print(json.dumps(row))
        fresh = {r["variant"] for r in rows}
        out = artifact(card, args.device, args.iters, args.app_iters,
                       [r for r in prev if r["variant"] not in fresh]
                       + rows)
        with open(art, "w") as f:
            json.dump(out, f, indent=1)
        return out

    if not args.skip_densify_pair:
        for name, densify in [("densify", True),
                              ("no_densify_control", False)]:
            _partition(scene, args.device)
            record(run_variant(scene, name, args.iters, densify,
                               args.device))

    # the appearance A/B/C on exposure/WB-jittered and vignetted training
    # views, the workload the appearance net exists for
    if not args.skip_appearance_pair:
        jscene = scene.rstrip("/") + "_jitter"
        if not os.path.isdir(os.path.join(jscene, "sparse")):
            os.makedirs(jscene, exist_ok=True)
            write_synthetic_scene(
                jscene, np.random.default_rng(11), n_points=N_POINTS,
                n_cams=N_CAMS, W=W, H=H, appearance_jitter=0.45,
                appearance_field=0.6, jitter_holdout=LLFFHOLD,
                device=args.device)
            print(f"jitter scene written: {jscene}")
        for name, app, share in [
                ("jitter_appearance_shared", True, True),
                ("jitter_appearance_on", True, False),
                ("jitter_appearance_off", False, False)]:
            _partition(jscene, args.device)
            record(run_variant(jscene, name, args.app_iters, densify=True,
                               device=args.device, appearance=app,
                               share_appearance=share))

    out = record()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
