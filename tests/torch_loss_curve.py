"""How far the port's loss curve drifts from the JAX package's over a few
hundred training steps on the CPU (ROADMAP C2).

    JAX_PLATFORMS=cpu python -m tests.torch_loss_curve [--steps 300]

Starts both packages from the state of ``tests/test_torch_train.py``'s
small scene (80 Gaussians, 6 cameras at 64x48, appearance on, SH degree 3)
and steps them through the same cameras in turn, with no densify. Prints,
every 25 steps, the largest relative loss gap so far, the first step at
which the pair counts differ (a Gaussian crossing a tile edge in one
package only) and the seconds per step of both packages together; the
last line is one JSON object with the whole curve. Too slow for tier-1:
it is run by hand.
"""

import argparse
import json
import tempfile
import time

import jax
import numpy as np

from tests.synthetic import write_synthetic_scene
from tests.test_torch_train import _Pair


def main(argv=None) -> dict:
    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        write_synthetic_scene(d, np.random.default_rng(3), n_points=80,
                              n_cams=6)
        pair = _Pair(d)
        pair.both_steps(0)                 # JAX compiles its step here
        curve, first_split = [], None
        t0 = time.perf_counter()
        for it in range(1, args.steps + 1):
            j_m, t_m = pair.both_steps(it % len(pair.j_cams))
            j, t = float(j_m["loss"]), float(t_m["loss"])
            curve.append({"step": it, "jax": j, "port": t,
                          "rel_gap": abs(t - j) / abs(j),
                          "n_pairs": [int(j_m["n_pairs"]), t_m["n_pairs"]]})
            if first_split is None and curve[-1]["n_pairs"][0] != \
                    curve[-1]["n_pairs"][1]:
                first_split = it
            if it % 25 == 0:
                print(f"step {it}: loss jax {j:.7f} port {t:.7f}, largest "
                      f"relative gap so far "
                      f"{max(c['rel_gap'] for c in curve):.3e}, pair counts "
                      f"first differ at {first_split}, "
                      f"{(time.perf_counter() - t0) / it:.3f} s a step",
                      flush=True)
        sec = (time.perf_counter() - t0) / args.steps
    out = {"steps": args.steps, "seconds_per_step": sec,
           "first_pair_count_split": first_split,
           "max_rel_gap": max(c["rel_gap"] for c in curve), "curve": curve}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
