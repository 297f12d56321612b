"""Dataclass-based config system (a copy of the JAX package's)."""
from repro_torch.config.base import (
    ConfigBase,
    apply_overrides,
    config_from_dict,
    config_to_dict,
    parse_cli_overrides,
)

__all__ = [
    "ConfigBase",
    "apply_overrides",
    "config_from_dict",
    "config_to_dict",
    "parse_cli_overrides",
]
