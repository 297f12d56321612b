"""Config system: frozen dataclasses + dotted-path CLI overrides + (de)serialization.

Design goals (framework-grade, not script-grade):
  * configs are immutable dataclasses — hashable, safe as cache keys;
  * every launcher accepts ``key=value`` / ``sub.key=value`` overrides;
  * round-trips to plain dicts (and therefore JSON) for checkpoint manifests,
    so a restart reconstructs the exact run configuration.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Tuple, Type, TypeVar, get_args, get_origin, get_type_hints

T = TypeVar("T", bound="ConfigBase")


@dataclasses.dataclass(frozen=True)
class ConfigBase:
    """Base class: all repro_torch configs derive from this.  Field names
    match the JAX package's configs, so ``cfg.to_dict()`` from one package
    feeds ``from_dict`` of the other."""

    def replace(self: T, **kw) -> T:
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return config_to_dict(self)

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls: Type[T], d: Dict[str, Any]) -> T:
        return config_from_dict(cls, d)

    @classmethod
    def from_json(cls: Type[T], s: str) -> T:
        return config_from_dict(cls, json.loads(s))


def config_to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: config_to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [config_to_dict(x) for x in cfg]
    if isinstance(cfg, dict):
        return {k: config_to_dict(v) for k, v in cfg.items()}
    return cfg


def _coerce(tp: Any, value: Any) -> Any:
    """Coerce a plain value into annotated type ``tp`` (handles Optional, tuples, nested configs)."""
    origin = get_origin(tp)
    if origin is not None:
        args = get_args(tp)
        if origin in (tuple,):
            if len(args) == 2 and args[1] is Ellipsis:
                return tuple(_coerce(args[0], v) for v in value)
            return tuple(_coerce(a, v) for a, v in zip(args, value))
        if origin in (list,):
            return [_coerce(args[0], v) for v in value]
        if origin in (dict,):
            return {k: _coerce(args[1], v) for k, v in value.items()}
        # Union / Optional: try each arm; a ``str`` arm takes only strings,
        # so a list (a capacity schedule from to_dict()) reaches its tuple arm
        for arm in get_args(tp):
            if arm is type(None):
                if value is None:
                    return None
                continue
            if arm is str and not isinstance(value, str):
                continue
            try:
                return _coerce(arm, value)
            except (TypeError, ValueError):
                continue
        return value
    if dataclasses.is_dataclass(tp) and isinstance(value, dict):
        return config_from_dict(tp, value)
    if tp in (int, float, str, bool) and value is not None:
        if tp is bool and isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return tp(value)
    return value


def config_from_dict(cls: Type[T], d: Dict[str, Any]) -> T:
    hints = get_type_hints(cls)
    kwargs = {}
    field_names = {f.name for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if k not in field_names:
            raise KeyError(f"{cls.__name__} has no field '{k}'")
        kwargs[k] = _coerce(hints.get(k, Any), v)
    return cls(**kwargs)


def parse_cli_overrides(argv: List[str]) -> Tuple[List[str], Dict[str, str]]:
    """Split argv into (positional, {dotted.key: value}) for ``key=value`` tokens."""
    positional, overrides = [], {}
    for tok in argv:
        if "=" in tok and not tok.startswith("-"):
            k, v = tok.split("=", 1)
            overrides[k] = v
        else:
            positional.append(tok)
    return positional, overrides


def _parse_literal(v: str) -> Any:
    try:
        return json.loads(v)
    except json.JSONDecodeError:
        return v


def apply_overrides(cfg: T, overrides: Dict[str, str]) -> T:
    """Apply {'a.b.c': 'value'} overrides to a nested frozen dataclass."""
    for dotted, raw in overrides.items():
        cfg = _apply_one(cfg, dotted.split("."), _parse_literal(raw))
    return cfg


def _apply_one(cfg: Any, path: List[str], value: Any) -> Any:
    if not dataclasses.is_dataclass(cfg):
        raise TypeError(f"cannot descend into non-config at '{path[0]}'")
    head, rest = path[0], path[1:]
    if not hasattr(cfg, head):
        raise KeyError(f"{type(cfg).__name__} has no field '{head}'")
    if rest:
        new_sub = _apply_one(getattr(cfg, head), rest, value)
        return dataclasses.replace(cfg, **{head: new_sub})
    hints = get_type_hints(type(cfg))
    return dataclasses.replace(cfg, **{head: _coerce(hints.get(head, Any), value)})
