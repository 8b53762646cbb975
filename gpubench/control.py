"""The control and the planted faults of the comparison that decides
``correct``, at a cell's own size, without the timed window.

The control is the plain reference put in the port's place and computed
one precision below what the configurations state: TF32 on for matmuls and
convolutions, where they state fp32 with TF32 off. A fault is the
reference in the port's place with one thing broken where it is produced:

- ``unchanged``: a step that returns its state unchanged (training);
- ``half``: the loss taken over half of the image, the mean over the rest
  (training);
- ``tile``: one 16x16 tile of the rendered image zeroed (both kinds).

Each reads the numbers the benchmark's runs compare, against the fp32
reference, on each seed given:

    python3 gpubench/control.py --workload <cell> --seeds 1,2,3
        [--variant control|half|tile|unchanged ...]

One JSON line a variant and seed. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gpubench import compare, harness, scene  # noqa: E402
from gpubench.drivers import render as render_driver  # noqa: E402
from gpubench.drivers import train as train_driver  # noqa: E402
from gpubench.reference import render as ref_render  # noqa: E402
from gpubench.reference import train as ref_train  # noqa: E402

VARIANTS = ("control", "half", "tile", "unchanged")


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def zero_tile(image: torch.Tensor) -> torch.Tensor:
    """The image with the tile at its centre zeroed."""
    h, w = image.shape[:2]
    y, x = (h // 2) // 16 * 16, (w // 2) // 16 * 16
    out = image.clone()
    out[y:y + 16, x:x + 16] = 0.0
    return out


class FaultyTrainer(ref_train.Trainer):
    """The reference trainer with one fault planted (``variant``)."""

    def __init__(self, *a, variant: str, **kw):
        super().__init__(*a, **kw)
        self.variant = variant

    def step(self, view, gt_u8, background, sh_degree):
        if self.variant == "unchanged":
            saved = {k: v.clone() for k, v in self.leaves().items()}
            out = super().step(view, gt_u8, background, sh_degree)
            for k, v in self.leaves().items():
                v.copy_(saved[k])
            for m in (self.m, self.v):
                for k in m:
                    m[k].zero_()
            return out
        real_render, real_loss = ref_render.render, ref_train.loss_of
        if self.variant == "tile":
            def render(prep, w, h, bg, counts=False):
                img, t = real_render(prep, w, h, bg)
                return zero_tile(img), t
            ref_render.render = render
        if self.variant == "half":
            def loss_of(image, gt, app, uid, lam, map_scale):
                h = image.shape[0] // 2
                return real_loss(image[:h], gt[:h], app, uid, lam, map_scale)
            ref_train.loss_of = loss_of
        try:
            return super().step(view, gt_u8, background, sh_degree)
        finally:
            ref_render.render, ref_train.loss_of = real_render, real_loss


def train_readings(spec: Dict, seed: int, variant: str, device) -> Dict:
    cfg, traffic = spec["config"], spec["traffic"]
    block = train_driver.Block(cfg, seed, device)
    start, n = int(traffic["start_iteration"]), int(traffic["check_steps"])
    order = scene.camera_order(seed, len(block.views), n + 1)
    if variant == "control":
        trainer = ref_train.Trainer
    else:
        def trainer(*a, **kw):
            return FaultyTrainer(*a, variant=variant, **kw)
    set_tf32(variant == "control")
    try:
        prog = train_driver.reference_run(block, start, n, order, trainer)
    finally:
        set_tf32(False)
    notes, values = train_driver.reference_check(block, start, n, order,
                                                 prog)
    return dict(values, notes=notes)


def render_readings(spec: Dict, seed: int, variant: str, device) -> Dict:
    cfg, traffic = spec["config"], spec["traffic"]
    sc = render_driver.Scene(cfg, seed, device)
    idx = scene.camera_order(seed, len(sc.views), int(traffic["check_views"]))
    gaps = []
    for i in idx:
        view = sc.views[i]
        set_tf32(variant == "control")
        try:
            prog = render_driver.reference_image(sc, view)
        finally:
            set_tf32(False)
        if variant == "tile":
            prog = zero_tile(torch.as_tensor(prog)).numpy()
        gaps.append(compare.image_gaps(prog, render_driver.reference_image(
            sc, view)))
    return {"image_mean_gap": max(g["mean"] for g in gaps),
            "notes": {"image_max_gap": max(g["max"] for g in gaps)}}


def readings(spec: Dict, seed: int, variant: str, device) -> Dict:
    kind = spec["traffic"]["kind"]
    if kind == "train":
        return train_readings(spec, seed, variant, device)
    if variant in ("half", "unchanged"):
        raise ValueError(f"no {variant} fault for a {kind} cell")
    return render_readings(spec, seed, variant, device)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", nargs="+", default=["control"],
                    choices=VARIANTS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    spec = harness.cell_spec(bench, args.workload)
    # the port's device defaults, which the reference runs under too
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    for variant in args.variant:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            r = readings(spec, seed, variant, "cuda")
            print(json.dumps({"workload": args.workload, "variant": variant,
                              "seed": seed, "readings": r,
                              "s": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
