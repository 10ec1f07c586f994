"""Name -> class registries (the reference's utils/registry.py:4-82)."""
from __future__ import annotations

from typing import Any, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def register(self, obj=None, name: Optional[str] = None):
        """Register ``obj`` under ``name`` (its ``__name__`` by default);
        called with no object, returns a decorator."""
        if obj is None:
            return lambda o: self.register(o, name)
        name = name or obj.__name__
        if name in self._obj_map and self._obj_map[name] is not obj:
            raise KeyError(
                f"'{name}' already registered in '{self._name}' registry"
            )
        self._obj_map[name] = obj
        return obj

    def get(self, name: str):
        if name not in self._obj_map:
            raise KeyError(
                f"'{name}' not found in '{self._name}' registry. "
                f"Available: {sorted(self._obj_map)}"
            )
        return self._obj_map[name]

    def keys(self):
        return sorted(self._obj_map)


ARCH_REGISTRY = Registry("arch")
DATASET_REGISTRY = Registry("dataset")
LOSS_REGISTRY = Registry("loss")
METRIC_REGISTRY = Registry("metric")
MODEL_REGISTRY = Registry("model")
