"""The port's merge (``pcp_tpu_torch/merge``) against the JAX package's:
the same block PLYs and records (the abutting cells of
``tests/test_partition.py``'s merge case, plus a third block above them)
give the same arrays and the same PLY bytes from ``seamless_merge``,
``cut_partition``, ``merge_ply_files`` and
``split_gaussians_by_x_midpoint``."""

import numpy as np
import pytest

from pcp_tpu import merge as jmerge
from pcp_tpu.partition import Box2D as JBox
from pcp_tpu.partition import PartitionRecord as JRec
from pcp_tpu_torch import merge as tmerge
from pcp_tpu_torch.io.ply import save_gaussian_ply
from pcp_tpu_torch.partition import Box2D as TBox
from pcp_tpu_torch.partition import PartitionRecord as TRec

CELLS = [("0", (-1, -1, 0, 1), -1.4, 0.4, -1, 1),
         ("1", (0, -1, 1, 1), -0.4, 1.4, -1, 1),
         ("2", (-1, 1, 1, 2), -1, 1, 0.8, 2.3)]


def _records(box_t, rec_t):
    return [rec_t(pid, box_t(*b), box_t(*b).expand_abs(1.0),
                  box_t(*b).expand_ratio(0.1), np.arange(1))
            for pid, b, *_ in CELLS]


def _block(n, xlo, xhi, ylo, yhi, seed):
    r = np.random.default_rng(seed)
    return {
        "xyz": np.stack([r.uniform(xlo, xhi, n), r.uniform(ylo, yhi, n),
                         r.uniform(-1, 1, n)], -1).astype(np.float32),
        "f_dc": r.normal(size=(n, 1, 3)).astype(np.float32),
        "f_rest": r.normal(size=(n, 15, 3)).astype(np.float32),
        "opacity": r.normal(size=(n, 1)).astype(np.float32),
        "scaling": r.normal(size=(n, 3)).astype(np.float32),
        "rotation": r.normal(size=(n, 4)).astype(np.float32),
    }


@pytest.fixture
def blocks(tmp_path):
    d = tmp_path / "blocks"
    d.mkdir()
    for i, (pid, _, *rng_box) in enumerate(CELLS):
        b = _block(60, *rng_box, seed=i)
        if pid == "1":   # an exact duplicate of a block-0 Gaussian
            b0 = _block(60, *CELLS[0][2:], seed=0)
            j = int(np.flatnonzero(b0["xyz"][:, 0] > 0)[0])
            for k in b:
                b[k][0] = b0[k][j]
        save_gaussian_ply(str(d / f"{pid}_point_cloud.ply"), b["xyz"],
                          b["f_dc"], b["f_rest"], b["opacity"],
                          b["scaling"], b["rotation"])
    return d


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_seamless_merge_matches(blocks, tmp_path):
    t_out, j_out = tmp_path / "t.ply", tmp_path / "j.ply"
    t = tmerge.seamless_merge(_records(TBox, TRec), str(blocks), str(t_out))
    j = jmerge.seamless_merge(_records(JBox, JRec), str(blocks), str(j_out))
    _equal(t, j)
    assert t_out.read_bytes() == j_out.read_bytes()
    assert 0 < len(t["xyz"]) < 180
    box = tmerge.dynamic_bounding_box(_records(TBox, TRec), 0)
    j_box = jmerge.dynamic_bounding_box(_records(JBox, JRec), 0)
    assert (box.xmin, box.ymin, box.xmax, box.ymax) == (
        j_box.xmin, j_box.ymin, j_box.xmax, j_box.ymax)
    assert box.xmin is None and box.xmax == 0 and box.ymax == 1


@pytest.mark.parametrize("prefilter", [False, True])
def test_cut_partition_matches(blocks, tmp_path, prefilter):
    ply = str(blocks / "0_point_cloud.ply")
    kw = dict(knn_prefilter=prefilter, min_neighbors=2, radius=0.5)
    t = tmerge.cut_partition(ply, TBox(-1, -1, 0, 1), str(tmp_path / "t.ply"),
                             **kw)
    j = jmerge.cut_partition(ply, JBox(-1, -1, 0, 1), str(tmp_path / "j.ply"),
                             **kw)
    _equal(t, j)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()


def test_folder_merge_and_split_match(blocks, tmp_path):
    t = tmerge.merge_ply_files(str(blocks), str(tmp_path / "t.ply"))
    j = jmerge.merge_ply_files(str(blocks), str(tmp_path / "j.ply"))
    _equal(t, j)
    assert len(t["xyz"]) == 179                # the duplicate went
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    tmerge.split_gaussians_by_x_midpoint(str(tmp_path / "t.ply"),
                                         str(tmp_path / "ts"))
    jmerge.split_gaussians_by_x_midpoint(str(tmp_path / "j.ply"),
                                         str(tmp_path / "js"))
    for part in ("part1.ply", "part2.ply"):
        assert (tmp_path / "ts" / part).read_bytes() == \
            (tmp_path / "js" / part).read_bytes()
