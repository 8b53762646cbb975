"""Reference-operating-point quality proof (counterpart of
``tools/quality_scale_run.py``).

The reference trains ~500k-point blocks of a multi-million-point scene for
30,000 iterations at ~1 MP while densifying toward millions of Gaussians
(shen_partition_utils.py:125 threshold 500k, arguments/__init__.py:90 iters
30000, train.py:146 cap 6e6). This tool drives that point end to end
through the port:

  1. scene:     a synthetic aerial scene, SfM points over a 96x96 slab, GT
                rendered on the card from a "true" cloud whose fine detail
                (sigma ~2 px) concentrates inside one block;
  2. partition: ``cli.partition`` at the preset's threshold (16 blocks);
  3. train:     the detail block through ``cli.train``: the preset's
                capacity, the full schedule, densify 500..15000 every 100,
                appearance on, no tile clamp; checkpoints every 2000
                iterations, and a rerun resumes from the newest
                ``chkpnt<N>.pth`` (the iterations resumed from land in the
                artifact's ``resumed_from``: the camera shuffle and the
                densify draws restart there from the seed, as in JAX);
  4. control:   the same block without densify (the quality bar);
  5. eval:      held-out PSNR/SSIM/LPIPS (synthetic-weights LPIPS,
                labelled) of every saved snapshot, the population and
                step-time curve from ``train_log.jsonl``, each variant's
                peak device memory, and GT from the dense oracle
                (``tools.oracle``) on ``PCP_ORACLE_VIEWS`` held-out views;
                the rows of an artifact already at ``--out`` for variants
                this eval did not score are kept, so each variant can
                train and be scored on a machine of its own (the scene and
                the partition come out the same from the same seed).

    [PCP_QSR_PRESET=ref100k] python -m pcp_tpu_torch.tools.quality_scale_run
        [--root DIR] [--phase scene|partition|train|control|eval|all]
        [--iters 30000] [--control_iters N] [--smoke] [--out PATH]
        [--device cpu]

``--smoke``: 1500 iterations each, the artifact under the root. Presets:
``ref500k`` (default) is the 24 GB tier (500k points a block, 1280x800,
cap 2^21); ``ref100k`` the reference's 8 GB tier (README.md:94-99:
threshold 100k), points and cap scaled 5x down, 800x512. The artifact is
``QUALITY_torch_<preset>.json`` at the repo root, with the card's name and
power limit. Everything runs on the card and raises without one;
``--device cpu`` runs it on the CPU.

Not carried over from the JAX tool (TPU-only): the power-of-two padding of
the Gaussian axis in the snapshot eval (a compile cache; pad rows cull to
nothing, so the images are the same), ``PCP_EVAL_BATCH``, and the catches
that let a wedged chip's run go on: here a failed snapshot or oracle view
raises.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import time

import numpy as np

from pcp_tpu_torch.tools.quality_run import LPIPS_NOTE, REPO, WORK, card_of

W, H = 1280, 800                 # 1.024 MP
FX = FY = 850.0
SLAB = 48.0                      # scene XY in [-SLAB, SLAB]
N_SFM = 8_000_000                # -> 16 blocks x 500k after median bisection
DETAIL_CENTER = np.array([12.0, 12.0])   # a block-center of the 4x4 split
DETAIL_R = 11.0
N_FINE = 1_300_000
N_COARSE = 700_000
N_CAMS_RING = 104                # over the detail block
N_CAMS_GRID = 56                 # across the rest of the slab
CAPACITY = 1 << 21
CAPACITY_CONTROL = 1 << 20
LLFFHOLD = 16
THRESHOLD = 500_000
CHECKPOINT_EVERY = 2000          # iterations between resumable checkpoints

# ref100k: the reference's other documented tier (README.md:94-99:
# threshold_value 100_000 for 8 GB GPUs), point counts and the densify cap
# 5x down, 800x512 (the tier fixes the point budget, not the resolution)
PRESET = os.environ.get("PCP_QSR_PRESET", "ref500k")
if PRESET == "ref100k":
    W, H = 800, 512
    FX = FY = 531.0
    N_SFM = 1_600_000            # -> 16 blocks x 100k
    N_FINE = 260_000
    N_COARSE = 140_000
    CAPACITY = 1 << 20
    CAPACITY_CONTROL = 1 << 18
    THRESHOLD = 100_000

def spectral_colors(xyz, rng, n_freq=48):
    """Natural-image-like colors: a pink-spectrum mixture of random 3D
    sinusoids, wavelengths log-spaced from ~the slab down to ~4 px at the
    camera distance. Gradient-guided densification needs GT with
    structure at all scales; uniform-random colours are white noise that
    photometric gradients cannot chase."""
    wavelengths = np.geomspace(24.0, 0.10, n_freq)
    freqs = (2 * np.pi / wavelengths)[:, None] * rng.normal(
        size=(n_freq, 3)).astype(np.float32)
    freqs /= np.linalg.norm(freqs / (2 * np.pi / wavelengths)[:, None],
                            axis=1, keepdims=True)
    phases = rng.uniform(0, 2 * np.pi, (n_freq, 1)).astype(np.float32)
    # pink-ish spectrum: amplitude ~ wavelength^0.45, normalized later
    amps = (wavelengths ** 0.45).astype(np.float32)
    mix = rng.normal(size=(n_freq, 3)).astype(np.float32) * amps[:, None]
    acc = np.zeros((xyz.shape[0], 3), np.float32)
    for k in range(n_freq):  # loop keeps peak memory ~ n x 3
        s = np.sin(xyz @ freqs[k] + phases[k])
        acc += s[:, None] * mix[k]
    acc /= 2.5 * np.std(acc)
    return np.clip(0.5 + acc, 0.02, 0.98).astype(np.float32)


def make_true_cloud(rng):
    """Fine detail inside the DETAIL disc + coarse splats elsewhere."""
    # fine: sigma ~ 2 px at the ~20-unit camera distance
    th = rng.uniform(0, 2 * np.pi, N_FINE)
    rr = DETAIL_R * np.sqrt(rng.uniform(0, 1, N_FINE))
    fine_xy = DETAIL_CENTER + np.stack([rr * np.cos(th), rr * np.sin(th)], 1)
    fine_z = rng.uniform(0.0, 2.5, N_FINE)
    fine_xyz = np.concatenate([fine_xy, fine_z[:, None]], 1)
    fine_scales = np.exp(rng.normal(np.log(0.05), 0.35, (N_FINE, 1))
                         ) * np.ones((1, 3))
    coarse_xy = rng.uniform(-SLAB, SLAB, (N_COARSE, 2))
    coarse_z = rng.uniform(0.0, 3.5, N_COARSE)
    coarse_xyz = np.concatenate([coarse_xy, coarse_z[:, None]], 1)
    coarse_scales = np.exp(rng.normal(np.log(0.35), 0.4, (N_COARSE, 1))
                           ) * np.ones((1, 3))
    xyz = np.concatenate([fine_xyz, coarse_xyz]).astype(np.float32)
    scales = np.concatenate([fine_scales, coarse_scales]).astype(np.float32)
    scales *= np.exp(rng.uniform(-0.3, 0.3, scales.shape)).astype(np.float32)
    n = xyz.shape[0]
    rgb = spectral_colors(xyz, rng)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    op = rng.uniform(0.55, 0.95, n).astype(np.float32)
    return xyz, rgb, scales, quats, op


def make_cameras(rng):
    """(pos, target) pairs: rings over the detail block + a slab grid."""
    cams = []
    for i in range(N_CAMS_RING):
        ring = i % 4
        r = 4.0 + 3.5 * ring
        ang = 2 * np.pi * (i // 4) / (N_CAMS_RING // 4) + 0.35 * ring
        pos = np.array([
            DETAIL_CENTER[0] + r * np.cos(ang),
            DETAIL_CENTER[1] + r * np.sin(ang),
            16.0 + 2.5 * ring,
        ])
        tgt = np.array([
            DETAIL_CENTER[0] + 0.35 * r * np.cos(ang + 2.2),
            DETAIL_CENTER[1] + 0.35 * r * np.sin(ang + 2.2),
            0.8,
        ])
        cams.append((pos, tgt))
    side = int(np.ceil(np.sqrt(N_CAMS_GRID)))
    k = 0
    for gy in range(side):
        for gx in range(side):
            if k >= N_CAMS_GRID:
                break
            k += 1
            pos = np.array([
                -SLAB + (2 * SLAB) * (gx + 0.5) / side + rng.uniform(-2, 2),
                -SLAB + (2 * SLAB) * (gy + 0.5) / side + rng.uniform(-2, 2),
                20.0 + rng.uniform(-2, 2),
            ])
            tgt = pos + np.array([rng.uniform(-6, 6), rng.uniform(-6, 6),
                                  -pos[2] + 0.5])
            cams.append((pos, tgt))
    return cams


def _intrin(dev):
    import torch

    from pcp_tpu_torch.ops.projection import CameraIntrin

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    return CameraIntrin(fx=f32(FX), fy=f32(FY), cx=f32(W / 2), cy=f32(H / 2))


def phase_scene(root, rng, device):
    import torch
    from PIL import Image as PILImage

    from pcp_tpu_torch.io import colmap
    from pcp_tpu_torch.ops.rasterize import rasterize
    from pcp_tpu_torch.tools.synthetic import look_at_w2c, viewmat_of
    from pcp_tpu_torch.utils.graphics import rotmat_to_qvec
    from pcp_tpu_torch.utils.sh import rgb_to_sh

    dev = torch.device(device)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    xyz, rgb, scales, quats, op = make_true_cloud(rng)
    cloud = [torch.as_tensor(a, device=dev) for a in (xyz, scales, quats, op)]
    sh = rgb_to_sh(torch.as_tensor(rgb, device=dev))[:, None, :]
    intrin = _intrin(dev)
    bg = torch.zeros(3, device=dev)

    cams = {1: colmap.Camera(1, "PINHOLE", W, H,
                             np.array([FX, FY, W / 2, H / 2]))}
    imgs = {}
    t0 = time.time()
    for i, (pos, tgt) in enumerate(make_cameras(rng)):
        R, t = look_at_w2c(pos, tgt)
        with torch.no_grad():
            img, _ = rasterize(*cloud, sh, viewmat_of(R, t), intrin, (W, H),
                               bg, 0, max_per_tile=4096, device=dev)
        img = np.clip(img.cpu().numpy(), 0, 1)
        name = f"im{i:04d}.png"
        PILImage.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(root, "images", name))
        npts = 20
        imgs[i + 1] = colmap.Image(
            i + 1, rotmat_to_qvec(R), t, 1, name,
            xys=np.zeros((npts, 2)),
            point3D_ids=np.arange(npts, dtype=np.int64))
        if i % 20 == 0:
            print(f"  gt view {i} ({time.time() - t0:.0f}s)")

    # SfM sparse cloud: real COLMAP output lies on surfaces and carries
    # photometric colours, so sample the true cloud with jitter, colours =
    # true colour + noise
    pick = rng.integers(0, xyz.shape[0], N_SFM)
    sfm_xyz = (xyz[pick]
               + rng.normal(0, 0.05, (N_SFM, 3))).astype(np.float32)
    sfm_rgb = np.clip(
        rgb[pick] + rng.normal(0, 0.04, (N_SFM, 3)), 0, 1)
    sfm_rgb = (sfm_rgb * 255).astype(np.uint8)
    pts = colmap.Points3D.from_arrays(sfm_xyz, sfm_rgb)
    colmap.write_model(cams, imgs, pts, os.path.join(root, "sparse", "0"),
                       ext=".bin")
    print(f"scene written: {root} ({time.time() - t0:.0f}s, "
          f"{len(imgs)} cams, {N_SFM} sfm pts, {xyz.shape[0]} true gauss)")
    return len(imgs)


def phase_partition(root, device):
    from pcp_tpu_torch.cli import partition

    t0 = time.time()
    # visible_rate 0.1: the detail cameras orbit the fine disc at close
    # range, so each view clips most of the block's hull; the reference's
    # 0.45 default assumes high-altitude full-block views
    partition.main([root, "--threshold", str(THRESHOLD),
                    "--expansion_distance", "8", "--visible_rate", "0.1",
                    "--no_plots", "--llffhold", "83", "--device", device])
    print(f"partition: {time.time() - t0:.1f}s")


def pick_block(root):
    """The block whose origin box contains DETAIL_CENTER."""
    with open(os.path.join(root, "model", "partition_data.pkl"), "rb") as f:
        records = pickle.load(f)
    for r in records:
        b = r.origin_box
        if (b.xmin <= DETAIL_CENTER[0] <= b.xmax
                and b.ymin <= DETAIL_CENTER[1] <= b.ymax):
            return r.partition_id
    raise RuntimeError("no block contains the detail center")


def block_dir_of(root, block_id):
    return os.path.join(root, "model", "split_result", "visible", block_id,
                        f"partition_{block_id}")


def _ckpt_iter(path: str) -> int:
    return int(os.path.basename(path)[len("chkpnt"):-len(".pth")])


RESUMES = "resumes.json"         # <out_dir>: the iterations resumed from
PHASE_TIMES = "phase_seconds.json"   # <root>: wall s of scene, partition


def _read_json(path: str, default):
    if not os.path.exists(path):
        return default
    with open(path) as f:
        return json.load(f)


def _note_phase(root: str, phase: str, seconds: float) -> None:
    p = os.path.join(root, PHASE_TIMES)
    times = _read_json(p, {})
    times[phase] = round(seconds, 2)
    with open(p, "w") as f:
        json.dump(times, f)


def _train_block(root, block_id, out_name, iters, densify, capacity,
                 test_iters, device):
    """Train (or resume) one variant; returns (out_dir, wall minutes).
    Its peak device memory lands in <out_dir>/memory.json."""
    import torch

    # in-loop held-out evals are optional (PCP_QSR_NO_EVAL=0 turns them
    # on): the artifact's numbers come from the eval phase and its curves
    # from train_log.jsonl
    if os.environ.get("PCP_QSR_NO_EVAL", "1") == "1":
        test_iters = []
    from pcp_tpu_torch.cli import train as train_cli

    out_dir = os.path.join(block_dir_of(root, block_id), out_name)
    ckpt_iters = list(range(CHECKPOINT_EVERY, iters, CHECKPOINT_EVERY))
    # dense early PLY snapshots: the snapshot curve's points (2500: the
    # JAX package's ref500k control record ends there, QUALITY_r04.json)
    save_iters = sorted({1000, 2000, 2500, 3000, 4000, 5000, 6000, 8000}
                        | set(range(10_000, iters + 1, 5000)) | {iters})
    save_iters = [i for i in save_iters if i <= iters]
    argv = [
        "-s", block_dir_of(root, block_id), "-m", out_dir,
        "--iterations", str(iters),
        "--capacity", str(capacity),
        "--max_per_tile", "0",
        "--resolution", "1",
        "--eval", "--llffhold", str(LLFFHOLD),
        "--disable_viewer",
        "--seed", "0",
        "--save_iterations", *[str(i) for i in save_iters],
        "--device", device,
    ]
    # "0" = never (the loop is 1-based); leaving the flag out would mean
    # the CLI's default [7000, 30000]
    argv += ["--test_iterations",
             *([str(i) for i in test_iters] if test_iters else ["0"])]
    if ckpt_iters:
        argv += ["--checkpoint_iterations", *[str(i) for i in ckpt_iters]]
    if densify:
        # the reference cadence (arguments/__init__.py:96-99): densify
        # 500..15000 every 100; then the population is frozen
        argv += ["--densify_from_iter", "500",
                 "--densify_until_iter", str(min(15_000, iters)),
                 "--densification_interval", "100",
                 "--opacity_reset_interval", "3000"]
    else:
        argv += ["--densify_from_iter", str(10 * iters)]
    # resume from the newest checkpoint if an earlier run stopped mid-way
    ckpts = sorted(glob.glob(os.path.join(out_dir, "chkpnt*.pth")),
                   key=_ckpt_iter)
    if ckpts:
        argv += ["--start_checkpoint", ckpts[-1]]
        print(f"resuming {out_name} from {ckpts[-1]}")
        # a resumed run restarts its camera shuffle and densify draws from
        # the seed (JAX's resume), so the artifact says where that happened
        res_p = os.path.join(out_dir, RESUMES)
        resumes = _read_json(res_p, [])
        with open(res_p, "w") as f:
            json.dump(resumes + [_ckpt_iter(ckpts[-1])], f)
    cuda = device != "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    train_cli.main(argv)
    mins = (time.time() - t0) / 60.0
    mem_p = os.path.join(out_dir, "memory.json")
    if cuda:
        free, total = torch.cuda.mem_get_info()
        mem = {"max_memory_allocated": int(torch.cuda.max_memory_allocated()),
               "mem_get_info_free": int(free),
               "mem_get_info_total": int(total)}
        if os.path.exists(mem_p):    # a resumed run keeps the larger peak
            with open(mem_p) as f:
                prev = json.load(f).get("max_memory_allocated", 0)
            mem["max_memory_allocated"] = max(mem["max_memory_allocated"],
                                              prev)
    else:
        mem = {"unavailable": "cpu"}
    with open(mem_p, "w") as f:
        json.dump(mem, f)
    return out_dir, mins


def train_log_curve(out_dir):
    """(population curve every 1000 steps, measured wall seconds) from
    <out_dir>/train_log.jsonl. The log is appended across resumes: the
    last row of an iteration wins, and a gap between rows counts at most
    5 minutes of training."""
    from pcp_tpu_torch.train.logging import every, read_log

    rows = read_log(out_dir)
    stamps = [r["ts"] for r in rows if "ts" in r]
    measured_wall_s = sum(min(max(b - a, 0.0), 300.0)
                          for a, b in zip(stamps, stamps[1:]))
    curve = [{"iter": it, "alive": int(r["total_points"]),
              "step_ms": round(1000 * r.get("iter_time", 0), 1),
              "n_pairs": int(r.get("n_pairs", 0))}
             for it, r in sorted(every(rows).items())]
    return curve, measured_wall_s


def phase_eval(root, block_id, variants, out_json, device):
    """Render held-out views from each variant's snapshots + metrics."""
    import torch

    from pcp_tpu_torch.eval.lpips import synthetic_weights
    from pcp_tpu_torch.eval.metrics import evaluate_images
    from pcp_tpu_torch.eval.render_batch import render_view
    from pcp_tpu_torch.io.ply import read_ply
    from pcp_tpu_torch.models import gaussians as G
    from pcp_tpu_torch.scene import cameras as cam_mod
    from pcp_tpu_torch.scene import load_scene, split_train_test
    from pcp_tpu_torch.tools.oracle import rasterize_dense
    from pcp_tpu_torch.utils.sh import rgb_to_sh

    t_eval = time.time()
    dev = torch.device(device)
    lpips_npz = os.path.join(root, "lpips_synth.npz")
    if not os.path.exists(lpips_npz):
        np.savez(lpips_npz, **synthetic_weights(0))

    scene = load_scene(block_dir_of(root, block_id), eval_split=True)
    _, test_infos = split_train_test(scene.cameras, True, LLFFHOLD)
    test_cams = [cam_mod.from_info(i, 1) for i in test_infos]
    print(f"eval: {len(test_cams)} held-out views")
    bg = torch.zeros(3, device=dev)

    def eval_snapshot(ply_path, full=True):
        """(alive, metrics, renders) of one PLY over the held-out views;
        LPIPS only when ``full``."""
        n = len(read_ply(ply_path)["x"])
        params, alive = G.load_gaussians_ply(
            ply_path, G.GaussianConfig(sh_degree=3, capacity=n), dev)
        renders = [render_view(params, alive, cam, 3, bg,
                               max_per_tile=4096, device=dev)[0]
                   for cam in test_cams]
        res = evaluate_images(
            renders, [cam.gt_image for cam in test_cams],
            lpips_weights=lpips_npz if full else None, device=dev)
        return n, res, renders

    rows = []
    memory = {}
    final_renders_by_variant = {}
    for name, out_dir, wall_min, iters in variants:
        # the newest snapshot at or below the scheduled end
        snaps = sorted(
            (int(os.path.basename(d)[len("iteration_"):]), d)
            for d in glob.glob(os.path.join(out_dir, "point_cloud",
                                            "iteration_*"))
            if int(os.path.basename(d)[len("iteration_"):]) <= iters)
        if not snaps:
            print(f"skip {name}: no PLY snapshot under {out_dir}")
            continue
        snap_curve = []
        for it_s, d_s in snaps[:-1]:
            n_s, res_s, _ = eval_snapshot(
                os.path.join(d_s, "point_cloud.ply"), full=False)
            snap_curve.append({
                "iter": it_s, "alive": int(n_s),
                "PSNR": res_s["mean"]["PSNR"],
                "SSIM": res_s["mean"]["SSIM"]})
            print(json.dumps({"snapshot": it_s, **snap_curve[-1]}))
        iters = snaps[-1][0]
        n_alive, res, final_renders = eval_snapshot(
            os.path.join(snaps[-1][1], "point_cloud.ply"), full=True)

        curve, measured_wall_s = train_log_curve(out_dir)
        if wall_min < 0 and measured_wall_s > 0:
            wall_min = measured_wall_s / 60.0
        evals = {}
        for p in glob.glob(os.path.join(out_dir, "eval_*.json")):
            it = os.path.basename(p)[len("eval_"):-len(".json")]
            with open(p) as f:
                evals[it] = json.load(f)
        mem_p = os.path.join(out_dir, "memory.json")
        if os.path.exists(mem_p):
            with open(mem_p) as f:
                memory[name] = json.load(f)
        final_renders_by_variant[name] = final_renders
        rows.append({
            "variant": name,
            "iterations": iters,
            "alive_final": n_alive,
            "max_alive": max([c["alive"] for c in curve], default=n_alive),
            "PSNR": res["mean"]["PSNR"],
            "SSIM": res["mean"]["SSIM"],
            "LPIPS": res["mean"]["LPIPS"],
            "lpips_weights": LPIPS_NOTE,
            "wall_minutes": round(wall_min, 1),
            "resumed_from": _read_json(os.path.join(out_dir, RESUMES), []),
            "card": card_of(device),
            "in_loop_evals": evals,
            "snapshot_curve": snap_curve,
            "population_curve": curve,
        })
        print(json.dumps({k: rows[-1][k] for k in
                          ("variant", "alive_final", "PSNR", "SSIM",
                           "LPIPS")}))

    # GT from the dense oracle over the true cloud (the production GT PNGs
    # went through the tiled composite; the oracle shares only the
    # projection with it), on a decimated subset of the held-out views
    oracle_sec = {"provenance": "tools/oracle.rasterize_dense over the "
                                f"true {N_FINE + N_COARSE}-Gaussian "
                                "cloud (seed 31), "
                                "tile-rect + CUDA skip/early-stop "
                                "semantics; independent of the "
                                "production tiled composite"}
    n_ov = int(os.environ.get("PCP_ORACLE_VIEWS", "4"))
    if n_ov > 0 and final_renders_by_variant:
        xyz_t, rgb_t, scales_t, quats_t, op_t = make_true_cloud(
            np.random.default_rng(31))
        sh_t = rgb_to_sh(rgb_t)[:, None, :]
        step = max(1, len(test_cams) // n_ov)
        idxs = list(range(0, len(test_cams), step))[:n_ov]
        oracle_gt = []
        seconds = []
        for i in idxs:
            t0o = time.time()
            og, _ = rasterize_dense(
                xyz_t, scales_t, quats_t, op_t, sh_t, test_cams[i].viewmat,
                _intrin(dev), (W, H), np.zeros(3, np.float32), 0,
                device=dev)
            oracle_gt.append(np.clip(og, 0, 1))
            seconds.append(round(time.time() - t0o, 2))
            print(f"  oracle GT view {i}: {seconds[-1]:.1f}s")
        png_gt = [test_cams[i].gt_image for i in idxs]
        bias = evaluate_images(png_gt, oracle_gt, device=dev)
        oracle_sec["views"] = idxs
        oracle_sec["seconds_per_view"] = seconds
        oracle_sec["production_gt_vs_oracle_gt"] = {
            "PSNR": bias["mean"]["PSNR"], "SSIM": bias["mean"]["SSIM"]}
        per_v = {}
        for nm, rnds in final_renders_by_variant.items():
            rv = evaluate_images([rnds[i] for i in idxs], oracle_gt,
                                 device=dev)
            per_v[nm] = {"PSNR": rv["mean"]["PSNR"],
                         "SSIM": rv["mean"]["SSIM"]}
        oracle_sec["per_variant"] = per_v
        print(json.dumps({"oracle_gt": oracle_sec}, default=float))

    phase_s = _read_json(os.path.join(root, PHASE_TIMES), {})
    phase_s["eval"] = round(time.time() - t_eval, 2)
    out = {
        "card": card_of(device),
        "device": device,
        "phase_seconds": phase_s,
        "oracle_gt": oracle_sec,
        "workload": {
            "preset": f"{PRESET} (threshold {THRESHOLD} pts/block; "
                      "ref100k = the reference's 8 GB-GPU tier, "
                      "README.md:94-99, densify cap scaled 5x with it)",
            "scene": f"synthetic aerial {N_SFM} SfM pts over "
                     f"{2*SLAB:.0f}x{2*SLAB:.0f}, GT from "
                     f"{N_FINE + N_COARSE} true Gaussians, {W}x{H} "
                     f"({W*H/1e6:.2f} MP)",
            "block": block_id,
            "schedule": "densify 500..15000 every 100, opacity reset "
                    "3000, appearance ON, capacity "
                    f"{CAPACITY} (control {CAPACITY_CONTROL}, no densify); "
                    "per-variant iteration counts in runs[]",
            "reference_bar": "500k-pt block, 30k iters, ~1MP, densify "
                             "toward multi-M Gaussians "
                             "(shen_partition_utils.py:125, "
                             "arguments/__init__.py:90, train.py:146)",
        },
        # per variant: torch.cuda.max_memory_allocated over its training
        # and mem_get_info after it
        "hbm": memory,
        "runs": rows,
    }
    _merge_earlier(out, out_json)
    with open(out_json, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"written": out_json}))
    return out


def _merge_earlier(out: dict, out_json: str) -> None:
    """Keeps the variants of an earlier artifact at ``out_json`` that this
    eval did not score (a variant trained and scored in a run of its own,
    on the same scene from the same seed): their rows, peak memory and
    oracle scores, and that run's phase times."""
    earlier = _read_json(out_json, None)
    if earlier is None:
        return
    mine = {r["variant"] for r in out["runs"]}
    kept = [r for r in earlier.get("runs", []) if r["variant"] not in mine]
    if not kept:
        return
    out["runs"] = kept + out["runs"]
    names = {r["variant"] for r in kept}
    out["hbm"] = {**{k: v for k, v in earlier.get("hbm", {}).items()
                     if k in names}, **out["hbm"]}
    per_v = earlier.get("oracle_gt", {}).get("per_variant", {})
    if "per_variant" in out["oracle_gt"]:
        out["oracle_gt"]["per_variant"] = {
            **{k: v for k, v in per_v.items() if k in names},
            **out["oracle_gt"]["per_variant"]}
    out["earlier_phase_seconds"] = earlier.get("phase_seconds", {})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join(WORK, f"scale_{PRESET}"))
    ap.add_argument("--phase", default="all",
                    choices=["scene", "partition", "train", "control",
                             "eval", "all"])
    ap.add_argument("--iters", type=int, default=30_000)
    ap.add_argument("--control_iters", type=int, default=0,
                    help="no-densify control schedule (0 = same as --iters)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=os.path.join(
        REPO, f"QUALITY_torch_{PRESET}.json"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from pcp_tpu_torch.device import resolve_device

    device = str(resolve_device(args.device))
    iters = 1500 if args.smoke else args.iters
    c_iters = args.control_iters or iters
    if args.smoke:
        c_iters = iters
    test_iters = ([500, 1500] if args.smoke
                  else sorted({1000, 3000, 5000, 7000, 15000, iters}))
    test_iters_c = ([500, 1500] if args.smoke else sorted(
        {i for i in (1000, 2500, 5000, 7000, 8500, 15000, c_iters)
         if i <= c_iters}))
    rng = np.random.default_rng(31)
    root = args.root
    phases = ([args.phase] if args.phase != "all"
              else ["scene", "partition", "train", "control", "eval"])

    if "scene" in phases and not os.path.isdir(
            os.path.join(root, "sparse")):
        os.makedirs(root, exist_ok=True)
        t0 = time.time()
        phase_scene(root, rng, device)
        _note_phase(root, "scene", time.time() - t0)
    if "partition" in phases and not os.path.exists(
            os.path.join(root, "model", "partition_data.pkl")):
        t0 = time.time()
        phase_partition(root, device)
        _note_phase(root, "partition", time.time() - t0)

    if not any(ph in phases for ph in ("train", "control", "eval")):
        return None
    block_id = pick_block(root)
    print(f"detail block: {block_id}")
    timings = {}
    suffix = "_smoke" if args.smoke else ""
    if "train" in phases:
        out_dir, mins = _train_block(
            root, block_id, f"output_densify{suffix}", iters, True,
            CAPACITY, test_iters, device)
        timings["densify"] = (out_dir, mins)
        print(f"train done in {mins:.1f} min")
    if "control" in phases:
        out_dir, mins = _train_block(
            root, block_id, f"output_control{suffix}", c_iters, False,
            CAPACITY_CONTROL, test_iters_c, device)
        timings["control"] = (out_dir, mins)
        print(f"control done in {mins:.1f} min")
    if "eval" not in phases:
        return None
    variants = []
    for name, key, it_v in [("densify", "densify", iters),
                            ("no_densify_control", "control", c_iters)]:
        od = os.path.join(block_dir_of(root, block_id),
                          f"output_{key}{suffix}")
        mins = timings.get(key, (None, -1))[1]
        if os.path.isdir(od):
            variants.append((name, od, mins, it_v))
    return phase_eval(root, block_id, variants,
                      args.out if not args.smoke
                      else os.path.join(root, "QUALITY_smoke.json"), device)


if __name__ == "__main__":
    main()
