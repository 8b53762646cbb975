"""pcp_tpu_torch.parallel — several blocks, or one large block, over one or
more cards (counterpart of ``pcp_tpu/parallel``): the fleet trains every
block of a partition at once (``fleet``), intra-block shards one block's
Gaussians over the ranks of a process group (``intra_block``), and
``distributed`` joins or starts the ranks, one per card."""

from pcp_tpu_torch.parallel.fleet import (  # noqa: F401
    FLEET_CKPT_NAME,
    CameraBank,
    build_camera_bank,
    make_fleet_step,
    make_fleet_step_banked,
    train_blocks_parallel,
)
from pcp_tpu_torch.parallel.intra_block import (  # noqa: F401
    SHARDED_CKPT_NAME,
    balance_for_sharding,
    sharded_render,
    train_scene_sharded,
)
