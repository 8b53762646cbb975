"""The frozen roofline counts the work the function needs on its inputs:
live Gaussians, not slots, and the samples the plain per-pixel loop
applies, whatever implements it."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import roofline, scene
from gpubench.drivers import train as train_driver
from gpubench.reference import render as R

HERE = Path(__file__).resolve().parents[1]


def _block(capacity, live=300, seed=7):
    cfg = {"capacity": capacity, "live": live, "sh_degree": 3,
           "fine_share": 0.8, "detail_center": [12.0, 12.0],
           "detail_radius": 11.0, "area": [0.0, 0.0, 24.0, 24.0],
           "z_fine": [0.0, 2.5], "z_coarse": [0.0, 3.5], "fine_sigma": 0.5,
           "coarse_sigma": 1.0, "sigma_logstd": 0.35, "opacity": [0.1, 0.8],
           "sh_rest_std": 0.02}
    return scene.gaussians(cfg, seed, "cpu")


def _view(w=48, h=32, fx=30.0):
    rig = {"ring_cameras": 4, "detail_center": [12.0, 12.0]}
    return scene.views({"width": w, "height": h, "fx": fx}, rig)[1]


def _snap(params, alive, view):
    return {"params": {k: v[alive] for k, v in params.items()},
            "view": view, "sh_degree": 3}


def test_dead_slots_leave_the_ideal_unchanged():
    view = _view()
    ideals = []
    for cap in (300, 512, 4096):
        params, alive = _block(cap)
        c = train_driver.counts_of(_snap(params, alive, view), "cpu")
        assert c["live"] == 300
        ideals.append(roofline.train_stages(c["live"], c, 3, view.width,
                                            view.height))
    assert ideals[0] == ideals[1] == ideals[2]
    assert all(v > 0 for v in ideals[0].values())


def _brute_force(prep, w, h):
    """(applied samples, pairs with one) by walking every pixel's tile list
    in the rasterizer's order, one Gaussian after another."""
    tiles_x = -(-w // R.TILE)
    n_tiles = tiles_x * -(-h // R.TILE)
    tile_bits = max(1, n_tiles.bit_length())
    rect = prep["rect"].numpy()
    depth = prep["depth"].detach().numpy().astype(np.float32)
    dbits = depth.view(np.uint32).astype(np.int64) >> tile_bits
    mean = prep["mean"].detach().numpy().astype(np.float64)
    conic = prep["conic"].detach().numpy().astype(np.float64)
    op = prep["opacity"].detach().numpy().astype(np.float64)
    samples, pairs = 0, set()
    for py in range(h):
        for px in range(w):
            tx, ty = px // R.TILE, py // R.TILE
            ids = [g for g in range(rect.shape[0])
                   if rect[g, 0] <= tx < rect[g, 2]
                   and rect[g, 1] <= ty < rect[g, 3]]
            ids.sort(key=lambda g: (dbits[g], g))
            t = 1.0
            for g in ids:
                dx, dy = px - mean[g, 0], py - mean[g, 1]
                power = (-0.5 * (conic[g, 0] * dx * dx + conic[g, 2] * dy * dy)
                         - conic[g, 1] * dx * dy)
                if power > 0:
                    continue
                alpha = min(R.ALPHA_MAX, op[g] * np.exp(power))
                if alpha < R.ALPHA_MIN:
                    continue
                if t * (1 - alpha) < R.T_EPS:
                    break
                t *= 1 - alpha
                samples += 1
                pairs.add((ty * tiles_x + tx, g))
    return samples, len(pairs)


def test_blend_samples_match_a_per_pixel_count():
    params, alive = _block(300, live=120, seed=3)
    view = _view(40, 24, 20.0)
    p = {k: v[alive] for k, v in params.items()}
    sh = torch.cat([p["f_dc"][:, None], p["f_rest"]], 1)
    prep = R.project(p["xyz"], torch.exp(p["scaling"]), p["rotation"],
                     torch.sigmoid(p["opacity"][:, 0]), sh,
                     torch.as_tensor(view.viewmat), view.fx, view.fy,
                     view.width, view.height, 3)
    _, _, c = R.render(prep, view.width, view.height, torch.zeros(3),
                       counts=True)
    samples, pairs = _brute_force(prep, view.width, view.height)
    assert c["samples"] > 100
    # the loop's transmittance is a float64 product here and an fp32
    # cumulative product there: a stop may move by one sample
    assert abs(c["samples"] - samples) <= 2
    assert abs(c["pairs"] - pairs) <= 1


@pytest.mark.parametrize("rel", ["roofline.py", "reference/render.py",
                                 "reference/train.py", "trace.py"])
def test_the_yardstick_imports_nothing_of_the_port(rel):
    tree = ast.parse((HERE / rel).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] == "pcp_tpu_torch"]


def test_ideals_are_functions_of_counts_alone():
    counts = {"visible": 1000, "pairs": 3000, "samples": 200_000,
              "pixels": 64 * 48}
    a = roofline.train_stages(1500, counts, 3, 64, 48)
    b = roofline.train_stages(1500, dict(counts), 3, 64, 48)
    assert a == b
    more = roofline.train_stages(1500, dict(counts, samples=10_000_000_000),
                                 3, 64, 48)
    assert more["composite_fwd"] > a["composite_fwd"]
    assert more["composite_bwd"] > a["composite_bwd"]
    assert more["preprocess"] == a["preprocess"]


def test_busy_counts_overlapping_operations_once():
    from gpubench import trace

    assert trace.busy_union([]) == 0.0
    # two overlapping operations, one inside another, then one alone
    assert trace.busy_union([(0.0, 4.0), (1.0, 2.0), (3.0, 6.0),
                             (8.0, 9.0)]) == pytest.approx(7.0)
