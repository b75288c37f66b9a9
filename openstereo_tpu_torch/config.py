"""YAML experiment configs: the port's own copy of `openstereo_tpu/config.py:19-64`.

Same section vocabulary (DATA_CONFIG / MODEL / ...) and the same
attribute-accessible dict, so the JAX package's YAML files load unchanged.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional


class Config(dict):
    """Attribute-accessible nested dict: cfg.MODEL.NAME."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict):
            return Config({k: Config._wrap(v) for k, v in value.items()})
        if isinstance(value, (list, tuple)):
            return type(value)(Config._wrap(v) for v in value)
        return value

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        return cls._wrap(dict(d))

    @classmethod
    def from_file(cls, path: str) -> "Config":
        import yaml

        with open(path, "r") as f:
            return cls.from_dict(yaml.safe_load(f))


def load_config(path: str) -> Config:
    return Config.from_file(path)


def get_valid_kwargs(fn, cfg: Dict[str, Any], ignore: Optional[List[str]] = None) -> Dict[str, Any]:
    """Filter a config section down to the lower-cased kwargs `fn` accepts;
    NAME and unknown keys are dropped (as `openstereo_tpu/config.py:67-89`)."""
    ignore = set(ignore or [])
    accepted = set(inspect.signature(fn).parameters)
    out = {}
    for k, v in cfg.items():
        lk = k.lower()
        if lk in ignore or lk == "name":
            continue
        if lk in accepted:
            out[lk] = v
    return out
