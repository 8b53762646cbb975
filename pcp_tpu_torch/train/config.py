"""Config dataclasses with the reference flag surface (counterpart of
``pcp_tpu/train/config.py``; ModelParams / OptimizationParams /
PipelineParams, arguments/__init__.py:47-114), and cfg_args persistence as
JSON, field for field the JAX package's ``cfg_args.json``.

Fields that size the JAX package's static tile tables (``tile_k_lo``,
``tile_hi_cap``, ``tile_levels``, ``active_cap``, ``pairs_per_gaussian``,
``pair_levels``, ``view_classes``) are kept so a config written by either
package loads in the other; exact binning sizes every view's pair list on
its own and reads none of them. ``max_per_tile`` is read: it is the
nearest-K clamp of a tile's list, and 0 (the JAX package's auto-size) means
no clamp.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class ModelConfig:
    """ModelParams (arguments/__init__.py:47-79)."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = False
    llffhold: int = 83
    # GT-image residency: "device" keeps each train image on the card as
    # uint8 after first use; "host" uploads it every step.
    data_device: str = "device"
    # partition knobs (VastGaussian grid partitioner)
    m_region: int = 3
    n_region: int = 3
    extend_rate: float = 0.2
    visible_rate: float = 0.25
    manhattan: bool = False
    platform: str = ""      # "cc" (cloudcompare) | "tj" (threejs)
    pos: str = "0 0 0"
    rot: str = "0 0 0"


@dataclass
class OptimConfig:
    """OptimizationParams (arguments/__init__.py:88-114)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 200
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 1000
    densify_until_iter: int = 30_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False
    appearance_embeddings_lr: float = 0.001
    appearance_network_lr: float = 0.001
    capacity: int = 1 << 20          # Gaussian slots of the block
    max_per_tile: int = 1024         # nearest-K clamp; 0 = no clamp
    # read by the JAX package's static tables only (module docstring)
    tile_k_lo: int = 0
    tile_hi_cap: int = 0
    tile_levels: str = ""
    active_cap: int = 0
    pairs_per_gaussian: int = 16
    pair_levels: str = ""
    view_classes: int = 1
    min_opacity: float = 0.005

    def tile_clamp(self) -> int:
        """The clamp ``bin_gaussians`` takes: max_per_tile, or no clamp."""
        return self.max_per_tile if self.max_per_tile > 0 else 1 << 30


@dataclass
class PipelineConfig:
    """PipelineParams (arguments/__init__.py:81-86)."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    use_appearance: bool = True
    share_appearance: bool = False     # the JAX fleet's; no fleet here yet
    app_map_scale: float = 1.0         # the JAX package's; 1 only here


@dataclass
class TrainRunConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    test_iterations: List[int] = field(default_factory=lambda: [7_000, 30_000])
    save_iterations: List[int] = field(default_factory=lambda: [7_000, 30_000])
    checkpoint_iterations: List[int] = field(default_factory=list)
    start_checkpoint: Optional[str] = None
    seed: int = 0


def save_cfg_args(model_path: str, cfg: TrainRunConfig) -> None:
    """Persist the config as ``cfg_args.json`` (train.py:177-178 writes
    cfg_args; JSON here, not an eval() of a repr)."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


def load_cfg_args(model_path: str) -> TrainRunConfig:
    with open(os.path.join(model_path, "cfg_args.json")) as f:
        d = json.load(f)
    return TrainRunConfig(
        model=ModelConfig(**d["model"]),
        optim=OptimConfig(**d["optim"]),
        pipeline=PipelineConfig(**d["pipeline"]),
        test_iterations=d.get("test_iterations", [7_000, 30_000]),
        save_iterations=d.get("save_iterations", [7_000, 30_000]),
        checkpoint_iterations=d.get("checkpoint_iterations", []),
        start_checkpoint=d.get("start_checkpoint"),
        seed=d.get("seed", 0),
    )
