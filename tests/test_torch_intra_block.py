"""The port's intra-block parallelism (``pcp_tpu_torch.parallel.
intra_block``) on the CPU, with gloo ranks.

- ``balance_for_sharding`` permutes the slots as the JAX package's does
  (numpy only on the JAX side: no compile);
- at D = 1 and D = 2 the sharded render and three sharded train steps
  equal the single-card ``render_gaussians`` and ``train_step_impl`` on
  the same balanced state: the image within 1e-6, the losses within 1e-6
  relative and the params within 1e-5 relative (D = 2 sums each
  Gaussian's gradient band by band, so only the rounding may differ);
- the shard-local densify keeps the same multiset of alive Gaussians as
  the single-block densify fed the same noise, when no shard runs out of
  slots;
- ``cli.auto_train --intra_block 2 --device cpu`` trains every block and
  writes its PLY.

The single-card step itself is held to JAX's by ``tests/test_torch_train.py``;
JAX's sharded trainer is not run here (its own tests are the suite's
longest). Every spawned group joins within ``JOIN_S`` seconds or fails.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.torch_parallel_workers import (
    TRAIN_FLAGS,
    block_plys,
    gt_u8,
    intra_cfg,
    intra_rank,
    intra_state,
    partitioned_scene,
)

JOIN_S = 120
STEPS = 3


@pytest.fixture(autouse=True)
def _one_thread_bounded_joins(monkeypatch):
    from pcp_tpu_torch.parallel import distributed as pdist

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(pdist, "JOIN_TIMEOUT_S", JOIN_S)
    monkeypatch.setenv("PCP_TENSORBOARD", "0")
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from tests.synthetic import write_synthetic_scene

    d = tmp_path_factory.mktemp("ibscene")
    write_synthetic_scene(str(d), np.random.default_rng(11), n_points=120,
                          n_cams=8)
    return str(d)


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_balance_matches_jax(d):
    from pcp_tpu.parallel.intra_block import balance_for_sharding as j_bal
    from pcp_tpu_torch.parallel.intra_block import balance_for_sharding

    rng = np.random.default_rng(d)
    c = 96
    alive = rng.uniform(size=c) < 0.4
    alive[:20] = True
    params = {"xyz": rng.normal(size=(c, 3)).astype(np.float32),
              "opacity": rng.normal(size=(c, 1)).astype(np.float32)}
    j_params, j_alive = j_bal(params, alive, d)
    t_params, t_alive = balance_for_sharding(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(alive), d)
    np.testing.assert_array_equal(t_alive.numpy(), np.asarray(j_alive))
    for k in params:
        np.testing.assert_array_equal(t_params[k].numpy(),
                                      np.asarray(j_params[k]))
    # every shard holds its share of the alive slots
    per_shard = t_alive.numpy().reshape(d, -1).sum(axis=1)
    assert per_shard.max() - per_shard.min() <= 1


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


@pytest.mark.parametrize("d", [1, 2])
def test_sharded_step_matches_single_card(scene_dir, tmp_path, d):
    from pcp_tpu_torch.parallel import distributed as pdist
    from pcp_tpu_torch.scene import cameras as tcam
    from pcp_tpu_torch.train.step import render_gaussians, train_step_impl

    out = str(tmp_path / "rank0.pt")
    pdist.spawn(intra_rank, d, "cpu", scene_dir, out, STEPS)
    got = torch.load(out, weights_only=True)

    scene, cams, state = intra_state(scene_dir, d)
    bg = torch.zeros(3)
    size = (cams[0].width, cams[0].height)
    with torch.no_grad():
        vm, intr = tcam.camera_tensors(cams[0], torch.device("cpu"))
        ref, _ = render_gaussians(state.params, state.alive, vm, intr, size,
                                  bg, 3, max_per_tile=128, device="cpu")
    np.testing.assert_allclose(got["image"].numpy(), ref.numpy(), rtol=0,
                               atol=1e-6)
    assert float(ref.abs().max()) > 0.05
    ocfg = intra_cfg().optim
    for i in range(STEPS):
        cam = cams[i % len(cams)]
        vm, intr = tcam.camera_tensors(cam, torch.device("cpu"))
        state, m = train_step_impl(
            state, vm, intr, gt_u8(cam), cam.uid, bg, scene.extent,
            ocfg=ocfg, image_size=size, sh_degree=3, use_appearance=True)
        loss = float(m["loss"])
        assert abs(got["losses"][i] - loss) <= 1e-6 * abs(loss), (i, d)
    np.testing.assert_array_equal(got["alive"].numpy(), state.alive.numpy())
    for k, v in state.params.items():
        assert _rel(got["params"][k], v) < 1e-5, (k, d)
    assert _rel(got["embeddings"], state.app["embeddings"]) < 1e-5
    if d == 1:
        for k, v in state.params.items():
            np.testing.assert_array_equal(got["params"][k].numpy(),
                                          v.numpy(), err_msg=k)


def test_sharded_densify_keeps_the_multiset(scene_dir):
    from pcp_tpu_torch.parallel.intra_block import shard_state
    from pcp_tpu_torch.train.step import densify_impl

    d = 2
    scene, _, full = intra_state(scene_dir, d, capacity=256)
    c = full.alive.shape[0]
    rng = np.random.default_rng(7)
    # gradients above the threshold on a third of the alive slots, screen
    # radii that prune nothing: clones and splits, no shard runs out
    hot = full.alive.numpy() & (rng.uniform(size=c) < 0.35)
    full.stats["grad_accum"] = torch.from_numpy(
        np.where(hot, 1e-2, 0.0).astype(np.float32))
    full.stats["denom"] = torch.ones(c)
    full.stats["max_radii2d"] = torch.ones(c)
    noise = tuple(torch.from_numpy(rng.normal(size=(c, 3)).astype(
        np.float32)) for _ in range(2))
    ocfg = intra_cfg(256).optim
    shards = [shard_state(full, d, r) for r in range(d)]
    one = densify_impl(full, None, scene.extent, ocfg=ocfg, prune_big=False,
                       noise=noise)
    n_one = int(one.alive.sum())
    assert n_one > int(hot.sum())
    rows = []
    per = c // d
    for r, st in enumerate(shards):
        sl = slice(r * per, (r + 1) * per)
        out = densify_impl(st, None, scene.extent, ocfg=ocfg,
                           prune_big=False,
                           noise=tuple(z[sl] for z in noise))
        assert int(out.alive.sum()) < per       # free slots left
        rows.append(torch.cat([v[out.alive].reshape(int(out.alive.sum()), -1)
                               for v in out.params.values()], 1))

    def multiset(x):
        x = x.numpy()
        return x[np.lexsort(x.T[::-1])]

    ref = torch.cat([v[one.alive].reshape(n_one, -1)
                     for v in one.params.values()], 1)
    np.testing.assert_array_equal(multiset(torch.cat(rows)), multiset(ref))


def test_cli_intra_block_trains_every_block(tmp_path):
    from pcp_tpu_torch.cli import auto_train

    visible = partitioned_scene(str(tmp_path / "scene"))
    auto_train.main(["--base_path", visible, "--intra_block", "2",
                     *TRAIN_FLAGS])
    plys = block_plys(visible)
    assert len(plys) == 4 and all(plys.values()), sorted(plys)
    manifest = json.loads(open(os.path.join(
        visible, "train_status.json")).read())
    assert sorted(manifest) == sorted(plys)
    assert all(v["status"] == "done" for v in manifest.values()), manifest
    for b in plys:
        out = os.path.join(visible, b, f"partition_{b}", "output")
        assert os.path.exists(os.path.join(out, "cfg_args.json"))
        log = open(os.path.join(out, "train_log.jsonl")).read()
        assert '"step": 1' in log
