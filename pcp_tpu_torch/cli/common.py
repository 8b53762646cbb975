"""Shared argparse wiring with the reference flag names
(arguments/__init__.py:47-114): model, optim and pipeline flags, and the
port's ``--device``."""

from __future__ import annotations

import argparse
import dataclasses

from pcp_tpu_torch.train.config import (
    ModelConfig,
    OptimConfig,
    PipelineConfig,
    TrainRunConfig,
)
from pcp_tpu_torch.utils.manhattan import get_man_trans, man_trans_from_cc


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-s", "--source_path", type=str, default="")
    p.add_argument("-m", "--model_path", type=str, default="")
    p.add_argument("-i", "--images", type=str, default="images")
    p.add_argument("-r", "--resolution", type=int, default=-1)
    p.add_argument("-w", "--white_background", action="store_true")
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--llffhold", type=int, default=83)
    p.add_argument("--manhattan", action="store_true")
    p.add_argument("--platform", type=str, default="")
    p.add_argument("--pos", type=str, default="0 0 0")
    p.add_argument("--rot", type=str, default="0 0 0")
    p.add_argument("--m_region", type=int, default=3)
    p.add_argument("--n_region", type=int, default=3)
    p.add_argument("--extend_rate", type=float, default=0.2)
    p.add_argument("--visible_rate", type=float, default=0.25)
    p.add_argument("--data_device", type=str, default="device",
                   choices=["device", "host"],
                   help="GT-image residency during training")


def add_optim_args(p: argparse.ArgumentParser) -> None:
    d = OptimConfig()
    for f in dataclasses.fields(OptimConfig):
        flag = "--" + f.name
        if isinstance(getattr(d, f.name), bool):
            p.add_argument(flag, action="store_true")
        else:
            p.add_argument(flag, type=type(getattr(d, f.name)),
                           default=getattr(d, f.name))


def add_pipeline_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--convert_SHs_python", action="store_true")
    p.add_argument("--compute_cov3D_python", action="store_true")
    p.add_argument("--debug", action="store_true",
                   help="check the loss every step; on the first non-finite "
                        "one dump the step's inputs to "
                        "nan_snapshot_<it>.npz and stop")
    p.add_argument("--no_appearance", action="store_true")
    p.add_argument("--share_appearance", action="store_true",
                   help="the fleet: one appearance net for every block")


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the CUDA card (default; fails without one) "
                        "or on the CPU")


def model_config_from_args(args) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(args, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def config_from_args(args) -> TrainRunConfig:
    oc = OptimConfig(**{f.name: getattr(args, f.name)
                        for f in dataclasses.fields(OptimConfig)})
    pc = PipelineConfig(
        convert_SHs_python=args.convert_SHs_python,
        compute_cov3D_python=args.compute_cov3D_python,
        debug=args.debug,
        use_appearance=not args.no_appearance,
        share_appearance=args.share_appearance,
    )
    return TrainRunConfig(model=model_config_from_args(args), optim=oc,
                          pipeline=pc)


def man_trans_from_config(mc: ModelConfig):
    """cc = cloudcompare 9-number rotation, otherwise threejs pos/rot
    strings (arguments/__init__.py:64-66)."""
    if not mc.manhattan:
        return None
    if mc.platform == "cc":
        return man_trans_from_cc(mc.pos, mc.rot)
    return get_man_trans(mc.pos, mc.rot)
