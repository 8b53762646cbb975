"""Metrics CLI — ``python -m pcp_tpu_torch.cli.metrics -m <model_path> [...]
[--device cpu]``.

Counterpart of ``pcp_tpu/cli/metrics.py`` (reference metrics.py:188-195):
walks <model>/<split>/ours_<tag>/ and writes renders_cc/, results.json and
per_view.json in each. ``main`` returns {method dir: evaluate_dir result}.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    from pcp_tpu_torch.cli.common import add_device_arg

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--model_paths", nargs="+", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--no_color_correct", action="store_true")
    p.add_argument("--lpips_weights", default=None)
    add_device_arg(p)
    args = p.parse_args(argv)

    from pcp_tpu_torch.device import resolve_device
    from pcp_tpu_torch.eval.lpips import make_lpips
    from pcp_tpu_torch.eval.metrics import evaluate_dir

    device = resolve_device(args.device)
    if make_lpips(args.lpips_weights, device) is None:
        print(
            "[metrics] LPIPS weights not found (pass --lpips_weights or set "
            "PCP_LPIPS_WEIGHTS: an .npz in the JAX package's layout, or "
            "torchvision's AlexNet and the LPIPS v0.1 heads as "
            "alexnet.pth,alex.pth) — LPIPS will be reported as null"
        )

    results = {}
    for model in args.model_paths:
        split_dir = os.path.join(model, args.split)
        if not os.path.isdir(split_dir):
            print(f"[metrics] no {args.split}/ under {model}")
            continue
        for method in sorted(os.listdir(split_dir)):
            mdir = os.path.join(split_dir, method)
            if not os.path.isdir(os.path.join(mdir, "renders")):
                continue
            out = results[mdir] = evaluate_dir(
                mdir,
                use_color_correct=not args.no_color_correct,
                lpips_weights=args.lpips_weights,
                device=device,
            )
            m = out["mean"]
            lp = f"{m['LPIPS']:.4f}" if m["LPIPS"] is not None else "n/a"
            print(
                f"{model} {method}: PSNR {m['PSNR']:.2f} "
                f"SSIM {m['SSIM']:.4f} LPIPS {lp}"
            )
    return results


if __name__ == "__main__":
    main()
