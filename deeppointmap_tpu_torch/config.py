"""Configuration: the argparse schema merged with a YAML file, a dict with
attribute access, and the defaults of the `tpu:` tree (port of
deeppointmap_tpu/config.py).

CLI parity with the reference (pipeline/parameters.py:37-82): the same
YAML-only trees and the same rule, YAML overrides console arguments. The
`tpu:` tree keeps its name so that one YAML file serves both packages; the
port reads the keys of its slices (`encoder_points`, `reg_buckets`,
`loop_batch_buckets`, `tile_member_buckets`, `extract_chunk`,
`upload_quant`, `upload_quant_lsb`, `infomat_stride`, `device_preprocess`,
`sweep_reuse`, `device_cache_mb`, `retain_nonkeyframe_pcd`,
`robust_register`, `sequence_parallel`, `odometer_pipeline_depth`,
`staleness_fallback`, `staleness_fallback_frac`, `agent_platform`,
`encoder_bf16` (the encoder's feature path in bfloat16 on a CUDA device,
models/encoder.py), `bf16` (the network's matrix products with bfloat16
operands and float32 accumulation on a CUDA device, utils/precision.py),
and for training `remat`, `data_parallel`) and ignores the rest: the
neighbour grades (every query of the port is exact but K4's) and
`checkpointer` (torch.save). PyYAML is imported only where a YAML file is
read. The training CLI (pipeline/train.py) reads the same YAML trees as
the JAX package's: configs/train/example.yaml loads as it is.
"""

from __future__ import annotations

import argparse
import logging
from typing import Any, Mapping

logger = logging.getLogger(__name__)


class Config(dict):
    """A dict with attribute access, applied recursively."""

    def __init__(self, d: Mapping | None = None, **kwargs):
        super().__init__()
        for k, v in dict(d or {}, **kwargs).items():
            self[k] = v

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Mapping) and not isinstance(value, Config):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return type(value)(Config._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, Config._wrap(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e


def str_to_bool(s: str) -> bool:
    if s.lower() == "true":
        return True
    if s.lower() == "false":
        return False
    raise argparse.ArgumentTypeError(f"{s!r} is not a boolean")


def build_parser() -> argparse.ArgumentParser:
    """The arguments of the JAX package's CLI that inference (single agent
    and multi-agent) and training read, plus `--device`."""
    p = argparse.ArgumentParser(description="DeepPointMap SLAM (PyTorch/CUDA)")
    p.add_argument("--name", default="DeepPointMap", type=str)
    p.add_argument("--version", default="v1.0", type=str)
    p.add_argument("--mode", default="infer", type=str,
                   choices=["train", "infer"])
    p.add_argument("--checkpoint", "-ckpt", default="", type=str,
                   help="Training checkpoint file, or a checkpoints "
                        "directory (its newest)")
    p.add_argument("--weight", "-w", default="", type=str,
                   help="Model weight file (.msgpack or .pth)")
    p.add_argument("--yaml_file", "-yaml", default="", type=str,
                   help="YAML config; values here override CLI values")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device of the engine (cuda, or cpu)")
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--use_cuda", default="true", type=str_to_bool,
                   help="Accepted for reference-CLI parity; --device decides")
    p.add_argument("--gpu_index", default="0", type=str)
    p.add_argument("--infer_src", default=[], type=list)
    p.add_argument("--infer_tgt", default="log_infer", type=str)
    p.add_argument("--multi_thread", "-mt", default=False,
                   action="store_true")
    p.add_argument("--use_ros", "-ros", default=False, action="store_true")
    p.add_argument("--profile", default=False, action="store_true",
                   help="write a torch.profiler Chrome trace of the run "
                        "under <infer_tgt>/profile")
    # multi-agent transport (pipeline/infer_multiagents.py)
    p.add_argument("--transport", default="inproc",
                   choices=["inproc", "tcp"],
                   help="multi-agent message transport")
    p.add_argument("--transport_host", default="127.0.0.1", type=str)
    p.add_argument("--transport_port", default=0, type=int,
                   help="cloud TCP port (0 = auto-pick)")
    p.add_argument("--agent_index", default=-1, type=int,
                   help=">=1: run as a single agent worker process "
                        "connecting to the cloud over TCP")
    # more than one device in training (pipeline/train.py)
    p.add_argument("--distributed", default=False, action="store_true",
                   help="join a torch.distributed process group before "
                        "training (one process per device)")
    p.add_argument("--coordinator_address", default="", type=str,
                   help="host:port of rank 0 (empty: torchrun's env)")
    p.add_argument("--num_processes", default=0, type=int)
    p.add_argument("--process_id", default=-1, type=int)
    # YAML-only trees
    for tree in ("dataset", "transforms", "encoder", "decoder", "train",
                 "loss", "slam_system"):
        p.add_argument(f"--{tree}", help="yaml tree")
    p.add_argument("--tpu", help="yaml tree: shape buckets and the options "
                                 "shared with the JAX package")
    return p


#: Defaults of the `tpu:` keys the port reads (the values of
#: deeppointmap_tpu/config.py TPU_DEFAULTS).
TPU_DEFAULTS = Config(
    # static size of padded encoder input point sets
    encoder_points=16384,
    reg_buckets=[256, 512, 1024, 2048, 4096],
    loop_batch_buckets=[1, 4, 16, 64],
    infomat_stride=4,
    # serve the encoder's stage-1 grouping from the preprocessing sweep's
    # widened candidate lists (models/encoder._group_from_sweep)
    sweep_reuse=False,
    # keep non-keyframe point clouds on the host (reference parity)
    retain_nonkeyframe_pcd=True,
    # sequences run at once, one engine per GPU (capped at the device
    # count; with --device cpu, that many CPU engines)
    sequence_parallel=1,
    # pipelined mode: frames launched on the device before the oldest
    # result is handed to mapping
    odometer_pipeline_depth=2,
    # pipelined mode: serialize the odometer against mapping while the
    # platform speed x the depth exceeds this share of the keyframe
    # distance (slam/system._update_staleness_mode)
    staleness_fallback=True,
    staleness_fallback_frac=0.9,
    # training: ranks of the data-parallel group ("auto" = the process
    # group's world size, 1 without one)
    data_parallel="auto",
    # training: recompute the encoder's activations in the backward pass
    # (torch.utils.checkpoint) instead of keeping them
    remat=False,
)


def update_args(args: Config, cfg: Mapping) -> Config:
    """Merge a YAML dict into args. YAML wins over CLI values."""
    for key, value in cfg.items():
        if key not in args:
            logger.warning("Unknown parameter in yaml file: %s", key)
        args[key] = value
    return args


def _with_tpu_defaults(args: Config) -> Config:
    tpu = Config(TPU_DEFAULTS)
    for k, v in (args.get("tpu") or {}).items():
        tpu[k] = v
    args.tpu = tpu
    return args


def _read_yaml(path: str) -> Mapping:
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f)


def load_config(argv: list[str] | None = None) -> Config:
    """Parse CLI args, merge the YAML file, return a Config."""
    args = Config(vars(build_parser().parse_args(argv)))
    if args.yaml_file:
        args = update_args(args, _read_yaml(args.yaml_file))
    return _with_tpu_defaults(args)


def config_from_dict(cfg: Mapping, **overrides) -> Config:
    """A Config from a dict shaped like the YAML files, with the `tpu:`
    tree laid over TPU_DEFAULTS."""
    args = Config(cfg)
    for k, v in overrides.items():
        args[k] = v
    return _with_tpu_defaults(args)


def config_from_yaml(yaml_path: str, **overrides) -> Config:
    """A Config from a YAML file such as configs/infer/sample.yaml, over
    the CLI defaults."""
    args = Config(vars(build_parser().parse_args([])))
    args = update_args(args, _read_yaml(yaml_path))
    for k, v in overrides.items():
        args[k] = v
    return _with_tpu_defaults(args)


def save_settings(args: Config, path: str) -> None:
    """Snapshot the resolved config (reference: pipeline/infer.py:92-95)."""
    with open(path, "w+", encoding="utf-8") as f:
        for k in sorted(args.keys()):
            f.write(f"{k}: {args[k]}\n")

