"""Minimal name -> constructor registry (``csts_tpu/utils/registry.py``; replaces
fvcore.common.registry.Registry)."""

from __future__ import annotations

from typing import Any, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def register(self, name_or_obj=None, obj: Optional[Any] = None):
        """Usable as decorator (``@REG.register()``), decorator with name, or direct
        call ``REG.register(name, obj)``."""
        if obj is not None:
            self._do_register(name_or_obj, obj)
            return obj
        if callable(name_or_obj) and not isinstance(name_or_obj, str):
            self._do_register(name_or_obj.__name__, name_or_obj)
            return name_or_obj

        def deco(o):
            self._do_register(name_or_obj or o.__name__, o)
            return o

        return deco

    def _do_register(self, name: str, obj: Any):
        if name in self._obj_map:
            raise KeyError(f"{name} already registered in {self._name}")
        self._obj_map[name] = obj

    def get(self, name: str) -> Any:
        if name not in self._obj_map:
            raise KeyError(f"{name} not found in {self._name} registry; "
                           f"available: {sorted(self._obj_map)}")
        return self._obj_map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def keys(self):
        return self._obj_map.keys()
