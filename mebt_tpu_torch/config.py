"""Layered YAML configuration, the part of mebt_tpu/config.py the CLI
needs: attribute access, deep merge and dot-list overrides.

`yaml` is imported inside the functions that parse text, so importing
this module needs no PyYAML.
"""

from __future__ import annotations

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
