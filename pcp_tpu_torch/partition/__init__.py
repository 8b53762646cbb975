"""pcp_tpu_torch.partition — point-count-balanced scene partitioner (VastGaussian-
style), vectorized.

Replaces the reference partition engine (scene/ptgs/): shen_partition_utils
(orchestrator), density_partition (balanced bisection), shen_partation_densify
(expansion / camera assignment / visibility selection), save_partition
(per-block COLMAP export). The reference's Python-loop hot spots (voxel
downsample dict loop, 48-thread per-camera projection) become single
vectorized array programs.

Counterpart of ``pcp_tpu/partition/__init__.py``.
"""

from pcp_tpu_torch.partition.types import Box2D, PartitionRecord  # noqa: F401
from pcp_tpu_torch.partition.density import balanced_bisection  # noqa: F401
from pcp_tpu_torch.partition.points import (  # noqa: F401
    radius_outlier_removal,
    voxel_downsample,
)
from pcp_tpu_torch.partition.visibility import (  # noqa: F401
    hull_area_ratio,
    project_points_batched,
    select_cameras_by_visibility,
)
from pcp_tpu_torch.partition.pipeline import ProgressiveDataPartitioning, run_partition  # noqa: F401
