"""Layered YAML configuration (mebt_tpu/config.py): attribute access,
deep merge, dot-list overrides and `target`/`params` instantiation,
without OmegaConf (reference train_transformer.py:25-27, utils.py:3-7).

`yaml` is imported inside the functions that parse text, so importing
this module needs no PyYAML.
"""

from __future__ import annotations

import copy
import importlib
from typing import Any, Iterable, Mapping


class Config(dict):
    """Dict with attribute access and deep conversion of nested mappings."""

    def __init__(self, data: Mapping | None = None, **kwargs):
        super().__init__()
        merged = dict(data or {})
        merged.update(kwargs)
        for k, v in merged.items():
            self[k] = _convert(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _convert(value)

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def get_path(self, dotted: str, default: Any = None) -> Any:
        """The value at `a.b.c`, or `default` where a key is missing."""
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, Mapping) and part in node:
                node = node[part]
            else:
                return default
        return node

    def to_dict(self) -> dict:
        def rec(v):
            if isinstance(v, Config):
                return {k: rec(x) for k, x in v.items()}
            if isinstance(v, list):
                return [rec(x) for x in v]
            return v

        return rec(self)


def _convert(v: Any) -> Any:
    if isinstance(v, Config):
        return v
    if isinstance(v, Mapping):
        return Config(v)
    if isinstance(v, list):
        return [_convert(x) for x in v]
    return v


def load_yaml(path: str) -> Config:
    import yaml

    with open(path) as f:
        return Config(yaml.safe_load(f) or {})


def merge(*configs: Mapping) -> Config:
    """Deep merge; later configs win. Lists are replaced, not
    concatenated (OmegaConf.merge semantics)."""
    out = Config()
    for cfg in configs:
        _merge_into(out, cfg)
    return out


def _merge_into(dst: Config, src: Mapping) -> None:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], Config) and isinstance(v, Mapping):
            _merge_into(dst[k], v)
        else:
            dst[k] = _convert(v)


def from_dotlist(items: Iterable[str]) -> Config:
    """Build a Config from ``a.b.c=value`` strings; values follow YAML
    scalar rules."""
    import yaml

    out = Config()
    for item in items:
        if "=" not in item:
            raise ValueError(f"dotlist item must be key=value, got: {item!r}")
        key, raw = item.split("=", 1)
        node = out
        parts = key.split(".")
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], Config):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = yaml.safe_load(raw)
    return out


def load_configs(bases: Iterable[str], overrides: Iterable[str] = ()) -> Config:
    """Merge base YAMLs, then dot-list overrides."""
    cfgs = [load_yaml(p) for p in bases]
    cfgs.append(from_dotlist(overrides))
    return merge(*cfgs)


# The reference instantiates its model and mask classes from `target`
# strings such as `mebt.mask_sampler.MaskGen` (utils.py:3-7, with a
# tats. -> mebt. rewrite); these map them onto this package, so the
# original YAML files work unchanged.
_TARGET_ALIASES = {
    "mebt.mask_sampler.MaskGen": "mebt_tpu_torch.sampler.mask_schedule.MaskGen",
    "tats.mask_sampler.MaskGen": "mebt_tpu_torch.sampler.mask_schedule.MaskGen",
    "mebt.transformer.Net2NetTransformer": "mebt_tpu_torch.models.mebt.MeBT",
    "tats.transformer.Net2NetTransformer": "mebt_tpu_torch.models.mebt.MeBT",
}


def resolve_target(target: str):
    """The class or function a dotted `target` names, after the aliases."""
    target = _TARGET_ALIASES.get(target, target)
    module, _, name = target.rpartition(".")
    return getattr(importlib.import_module(module), name)


def instantiate_from_config(config: Mapping, **extra) -> Any:
    """`target(**params, **extra)` of a `target`/`params` mapping."""
    if "target" not in config:
        raise KeyError("Expected key `target` to instantiate.")
    cls = resolve_target(config["target"])
    params = dict(config.get("params", {}) or {})
    params.update(extra)
    return cls(**params)
