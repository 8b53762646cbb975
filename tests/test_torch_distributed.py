"""The port's ranks (``pcp_tpu_torch.parallel.distributed``) on the CPU,
with gloo processes.

- ``local_block_slice`` is the JAX package's arithmetic;
- ``initialize`` joins nothing without torchrun's environment;
- ``cli.auto_train --n_devices 2 --device cpu`` on the 4 blocks of the
  partitioned 120-point scene writes the PLY bytes of ``--n_devices 1``,
  with and without ``--share_appearance`` (the shared appearance sums its
  gradients in global block order, whatever the number of ranks);
- 3 ranks on 2 blocks: the rank without blocks joins every collective and
  finishes, and the blocks get the 1-rank bytes;
- ``--retry_failed`` trains only the blocks not done, each with the draws
  of its index among all the blocks, so they write the whole fleet's
  bytes.

Every spawned group joins within ``JOIN_S`` seconds or fails.
"""

import json
import os
import shutil

import pytest
import torch

from tests.torch_parallel_workers import (
    TRAIN_FLAGS,
    block_plys,
    partitioned_scene,
)

JOIN_S = 120


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
def blocks_dir(tmp_path_factory):
    return partitioned_scene(str(tmp_path_factory.mktemp("dist") / "scene"))


@pytest.mark.parametrize("n_blocks,n_proc", [(4, 1), (4, 2), (4, 3), (5, 2),
                                              (2, 3), (7, 4), (1, 2)])
def test_local_block_slice_matches_jax(monkeypatch, n_blocks, n_proc):
    import jax

    from pcp_tpu.parallel import distributed as j_dist
    from pcp_tpu_torch.parallel.distributed import local_block_slice

    monkeypatch.setattr(jax, "process_count", lambda: n_proc)
    owned = []
    for pid in range(n_proc):
        monkeypatch.setattr(jax, "process_index", lambda pid=pid: pid)
        j = j_dist.local_block_slice(n_blocks)
        t = local_block_slice(n_blocks, pid, n_proc)
        assert list(range(n_blocks))[t] == list(range(n_blocks))[j]
        owned += list(range(n_blocks))[t]
    assert owned == list(range(n_blocks))


def test_initialize_without_torchrun_env(monkeypatch):
    import torch.distributed as dist

    from pcp_tpu_torch.parallel.distributed import TORCHRUN_ENV, initialize

    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert initialize("cpu") is None
    assert not dist.is_initialized()


def _train(src, dst, flags):
    from pcp_tpu_torch.cli import auto_train

    shutil.copytree(src, dst)
    auto_train.main(["--base_path", str(dst), *flags, *TRAIN_FLAGS])
    manifest = json.loads(open(os.path.join(dst, "train_status.json")).read())
    assert all(v["status"] == "done" for v in manifest.values()), manifest
    plys = block_plys(str(dst))
    assert plys and all(plys.values()), sorted(plys)
    return plys


@pytest.fixture(scope="module")
def one_rank(blocks_dir, tmp_path_factory):
    """``one_rank(flags)``: the 1-rank fleet's PLY bytes, each set of
    flags trained once."""
    done = {}

    def get(flags):
        if tuple(flags) not in done:
            done[tuple(flags)] = _train(
                blocks_dir, tmp_path_factory.mktemp("one") / "scene", flags)
        return done[tuple(flags)]

    return get


@pytest.mark.parametrize("share", [[], ["--share_appearance"]])
def test_two_ranks_write_the_one_rank_bytes(blocks_dir, one_rank, tmp_path,
                                            share):
    one = one_rank(share)
    two = _train(blocks_dir, tmp_path / "two", ["--n_devices", "2", *share])
    assert len(one) == 4
    assert two == one


def test_rank_without_blocks_finishes(blocks_dir, tmp_path):
    two_blocks = tmp_path / "src"
    os.makedirs(two_blocks)
    for b in sorted(os.listdir(blocks_dir))[:2]:
        shutil.copytree(os.path.join(blocks_dir, b), two_blocks / b)
    flags = ["--share_appearance", "--device_data"]
    one = _train(two_blocks, tmp_path / "one", flags)
    three = _train(two_blocks, tmp_path / "three",
                   ["--n_devices", "3", *flags])
    assert len(one) == 2 and three == one


def test_retry_keeps_each_blocks_seeds(blocks_dir, one_rank, tmp_path):
    from pcp_tpu_torch.cli import auto_train

    whole = one_rank([])
    ids = sorted(whole)
    dst = tmp_path / "retry"
    shutil.copytree(blocks_dir, dst)
    # blocks 0 and 2 done: blocks 1 and 3 form the fleet, at positions 0
    # and 1, and must still draw as blocks 1 and 3
    (dst / "train_status.json").write_text(json.dumps(
        {b: {"status": "done"} for b in ids[::2]}))
    auto_train.main(["--base_path", str(dst), "--retry_failed",
                     *TRAIN_FLAGS])
    plys = block_plys(str(dst))
    assert all(plys[b] is None for b in ids[::2])
    assert {b: plys[b] for b in ids[1::2]} == {b: whole[b]
                                                for b in ids[1::2]}
    manifest = json.loads((dst / "train_status.json").read_text())
    assert all(v["status"] == "done" for v in manifest.values()), manifest
