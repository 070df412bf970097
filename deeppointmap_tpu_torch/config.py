"""Configuration: a dict with attribute access, the defaults of the `tpu:`
tree, and loaders from a dict or a YAML file (port of
deeppointmap_tpu/config.py).

The `tpu:` tree keeps its name so that one YAML file serves both packages;
the port reads the keys of its slice (`reg_buckets`, `loop_batch_buckets`,
`extract_chunk`, `upload_quant`, `upload_quant_lsb`, `infomat_stride`)
and ignores the rest. PyYAML is imported only by `config_from_yaml`.
"""

from __future__ import annotations

from typing import Any, Mapping


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


#: Defaults of the `tpu:` keys the port reads (the values of
#: deeppointmap_tpu/config.py TPU_DEFAULTS).
TPU_DEFAULTS = Config(
    reg_buckets=[256, 512, 1024, 2048, 4096],
    loop_batch_buckets=[1, 4, 16, 64],
    infomat_stride=4,
)


def config_from_dict(cfg: Mapping, **overrides) -> Config:
    """A Config from a dict shaped like the YAML files, with the `tpu:`
    tree laid over TPU_DEFAULTS."""
    args = Config(cfg)
    for k, v in overrides.items():
        args[k] = v
    tpu = Config(TPU_DEFAULTS)
    for k, v in (args.get("tpu") or {}).items():
        tpu[k] = v
    args.tpu = tpu
    return args


def config_from_yaml(yaml_path: str, **overrides) -> Config:
    """A Config from a YAML file such as configs/infer/sample.yaml."""
    import yaml

    with open(yaml_path, "r", encoding="utf-8") as f:
        return config_from_dict(yaml.safe_load(f), **overrides)
