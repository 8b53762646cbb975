"""pcp_tpu_torch.merge — cut trained blocks to their bisection cells and fuse into
one scene PLY (scene/ptgs/{merge_partitions,cut_partition}.py and the
scene/sever_code/ toolbox).

Counterpart of ``pcp_tpu/merge/__init__.py``.
"""

from pcp_tpu_torch.merge.merge import (  # noqa: F401
    cut_partition,
    dynamic_bounding_box,
    merge_ply_files,
    seamless_merge,
    split_gaussians_by_x_midpoint,
)
