"""Config system: defaults + YAML file merge + dotted-key overrides.

The same public API and behaviour as ``detectron_tpu.config``
(``cfg_from_file``, ``cfg_from_list``, ``get_config``) on the port's own
:class:`AttrDict` and YAML reader, so the port needs neither
``ml_collections`` nor PyYAML.
"""

from __future__ import annotations

from typing import Iterable, Mapping

from detectron_tpu_torch.config import yaml_lite
from detectron_tpu_torch.config.attrdict import AttrDict
from detectron_tpu_torch.config.defaults import base_config

__all__ = ["AttrDict", "base_config", "get_config", "cfg_from_file",
           "cfg_from_list"]


def _merge(cfg: AttrDict, other: Mapping) -> None:
    for key, value in other.items():
        if key not in cfg:
            raise KeyError(f"unknown config key: {key!r}")
        current = cfg[key]
        if isinstance(current, AttrDict):
            if not isinstance(value, Mapping):
                raise TypeError(f"config key {key!r} expects a mapping")
            _merge(current, value)
        else:
            cfg[key] = value


def cfg_from_file(path: str, cfg: AttrDict | None = None) -> AttrDict:
    """Load a YAML config file and merge it over the defaults."""
    cfg = cfg if cfg is not None else base_config()
    with open(path) as f:
        loaded = yaml_lite.loads(f.read()) or {}
    _merge(cfg, loaded)
    return cfg


def cfg_from_list(pairs: Iterable[str], cfg: AttrDict | None = None) -> AttrDict:
    """Apply ``key.subkey=value`` override strings (CLI)."""
    cfg = cfg if cfg is not None else base_config()
    for pair in pairs:
        key, eq, raw = pair.partition("=")
        if not eq:
            raise ValueError(f"override must be key=value, got {pair!r}")
        node = cfg
        parts = key.strip().split(".")
        for part in parts[:-1]:
            node = node[part]
        leaf = parts[-1]
        old = node[leaf]
        value = yaml_lite.parse_value(raw)
        if isinstance(old, str) and not isinstance(value, str):
            # YAML 1.1 reads on/off/yes/no as bools and bare numbers as
            # ints: a string-typed knob such as model.fused_roi_align=on
            # keeps the literal text
            value = raw.strip()
        node[leaf] = value
    return cfg


def get_config(path: str | None = None, overrides: Iterable[str] = ()) -> AttrDict:
    """defaults -> optional YAML -> optional CLI overrides."""
    cfg = base_config()
    if path:
        cfg_from_file(path, cfg)
    if overrides:
        cfg_from_list(overrides, cfg)
    return cfg
