"""Dataclass-driven CLI (tyro-lite; a copy of ``gstk_tpu/configs/cli.py``).

The reference exposes every nested config field as a CLI flag via tyro
(``gs_toolkit/configs/method_configs.py:221-229``). tyro is not available in
this image, so this module provides the same user-facing surface with
argparse: every field of a (nested) dataclass becomes ``--path.to.field``,
subcommands select method configs, and parsed values are applied as dataclass
replacements. Booleans accept explicit True/False values like tyro. Unlike
gstk_tpu's copy, a ``Literal`` field is a flag with its values as choices
(``--camera-opt.mode SO3xR3``).
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import typing
from pathlib import Path
from typing import Any, Dict


def _unwrap_optional(tp):
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


def _parse_bool(v: str) -> bool:
    if v.lower() in ("1", "true", "yes", "on"):
        return True
    if v.lower() in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"invalid bool: {v}")


def add_dataclass_args(
    parser: argparse.ArgumentParser, obj, prefix: str = ""
) -> None:
    """Register one flag per (nested) dataclass field.

    ``obj`` may be an instance (preferred — nested fields use the *runtime*
    type, so e.g. co-gs's DepthConfig flags appear even though the declared
    field type is VanillaConfig) or a class.
    """
    cls = obj if isinstance(obj, type) else type(obj)
    for f in dataclasses.fields(cls):
        tp, _ = _unwrap_optional(
            f.type if not isinstance(f.type, str) else _resolve(cls, f.name)
        )
        name = f"{prefix}{f.name}".replace("_", "-")
        if dataclasses.is_dataclass(tp):
            child = (
                getattr(obj, f.name) if not isinstance(obj, type) else tp
            )
            add_dataclass_args(parser, child, prefix=f"{prefix}{f.name}.")
            continue
        if tp is bool:
            parser.add_argument(f"--{name}", type=_parse_bool, default=None)
        elif tp in (int, float, str):
            parser.add_argument(f"--{name}", type=tp, default=None)
        elif tp is Path:
            parser.add_argument(f"--{name}", type=Path, default=None)
        elif typing.get_origin(tp) is typing.Literal:
            parser.add_argument(f"--{name}", type=str, default=None,
                                choices=[str(v) for v in typing.get_args(tp)])
        elif isinstance(tp, type) and issubclass(tp, enum.Enum):
            parser.add_argument(
                f"--{name}", type=str, default=None,
                choices=[e.value for e in tp],
            )
        # tuples/complex types are config-file-only


def _resolve(cls, field_name):
    hints = typing.get_type_hints(cls)
    return hints[field_name]


def apply_overrides(instance, overrides: Dict[str, Any], prefix: str = ""):
    """Apply {dotted.path: value} overrides, rebuilding frozen dataclasses."""
    updates = {}
    for f in dataclasses.fields(instance):
        key = f"{prefix}{f.name}"
        val = getattr(instance, f.name)
        if dataclasses.is_dataclass(val) and not isinstance(val, type):
            new_val = apply_overrides(val, overrides, prefix=f"{key}.")
            if new_val is not val:
                updates[f.name] = new_val
        elif key in overrides and overrides[key] is not None:
            updates[f.name] = overrides[key]
    if updates:
        return dataclasses.replace(instance, **updates)
    return instance


def parse_cli(description: str, configs: Dict[str, Any], argv=None):
    """Subcommand CLI: ``prog <method> [--flags]`` -> configured instance."""
    parser = argparse.ArgumentParser(description=description)
    sub = parser.add_subparsers(dest="command", required=True)
    for name, cfg in configs.items():
        p = sub.add_parser(name)
        add_dataclass_args(p, cfg)
    ns = parser.parse_args(argv)
    base = configs[ns.command]
    overrides = {
        k: v for k, v in vars(ns).items() if k != "command" and v is not None
    }
    return ns.command, apply_overrides(base, overrides)
