"""Name → object registry: the port's own copy of `openstereo_tpu/registry.py:13-47`.

Backs the port's datasets and transforms, so configs name them as the JAX
package's YAML files do.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._obj_map: Dict[str, Any] = {}

    def register(self, obj: Any = None, *, name: Optional[str] = None) -> Any:
        """Use as decorator (`@REG.register` / `@REG.register(name=...)`) or call."""
        if obj is None:
            return lambda o: self.register(o, name=name)
        key = name or obj.__name__
        if key in self._obj_map:
            raise KeyError(f"{key!r} already registered in {self.name!r}")
        self._obj_map[key] = obj
        return obj

    def get(self, name: str) -> Any:
        if name not in self._obj_map:
            raise KeyError(f"{name!r} not found in registry {self.name!r}; "
                           f"available: {sorted(self._obj_map)}")
        return self._obj_map[name]


DATASETS = Registry("datasets")
TRANSFORMS = Registry("transforms")
