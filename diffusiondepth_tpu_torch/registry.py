"""Name -> constructor registries (a copy of the ``Registry`` of
``diffusiondepth_tpu.registry``) for the backbones and heads that
``backbone_name`` and ``head_specify`` select, and the depth transforms
that a head's ``depth_transform_cfg`` names."""

from __future__ import annotations

from typing import Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._module_dict: Dict[str, Callable] = {}

    def register(self, obj: Optional[Callable] = None, *, name: Optional[str] = None):
        def _register(o):
            key = name or o.__name__
            if key in self._module_dict:
                raise KeyError(f"{key} already registered in {self.name}")
            self._module_dict[key] = o
            return o

        if obj is None:
            return _register
        return _register(obj)

    def get(self, key: str) -> Callable:
        if key not in self._module_dict:
            raise KeyError(
                f"{key!r} not found in registry {self.name!r}; "
                f"available: {sorted(self._module_dict)}"
            )
        return self._module_dict[key]

    def build(self, cfg, **extra_kwargs):
        """From a name or an mmcv-style cfg dict ``{'type': name, **kwargs}``."""
        if isinstance(cfg, str):
            return self.get(cfg)(**extra_kwargs)
        if isinstance(cfg, dict):
            cfg = dict(cfg, **extra_kwargs)
            return self.get(cfg.pop("type"))(**cfg)
        raise TypeError(f"cfg must be str or dict, got {type(cfg)}")


BACKBONES = Registry("backbones")
HEADS = Registry("heads")
DEPTH_TRANSFORMS = Registry("depth_transforms")
