"""Config save/load (port of ``gstk_tpu/configs/serialize.py``).

The trainer saves its config next to the outputs as ``config.yml``, and the
eval, render and export CLIs reload it. Nested dataclasses carry a
``__class__`` tag so subclasses (DepthConfig, SurfaceConfig) round-trip.

The file is JSON, which PyYAML reads too, so gstk_tpu's ``load_config``
reads the port's file and the port needs no PyYAML to write it. Floats are
written as PyYAML writes them (``1.0e-15``, not ``1e-15``, which PyYAML
would read as a string; infinity as ``1.0e+999``). Class tags name
gstk_tpu's module paths, so each package reads the file into its own
classes: :func:`from_dict` maps a ``gstk_tpu.`` or ``gstk_torch.`` tag to
the port's class of the same module path and name, imports nothing else,
and raises when the port has no such class.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
from pathlib import Path
from typing import Any

_PACKAGE = "gstk_torch"
_SHARED_PACKAGE = "gstk_tpu"  # the package whose class paths the file names


def to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        module = type(obj).__module__
        if module.split(".")[0] == _PACKAGE:
            module = _SHARED_PACKAGE + module[len(_PACKAGE):]
        out = {"__class__": f"{module}.{type(obj).__qualname__}"}
        for f in dataclasses.fields(obj):
            out[f.name] = to_dict(getattr(obj, f.name))
        return out
    if isinstance(obj, Path):
        return {"__path__": str(obj)}
    if isinstance(obj, (list, tuple)):
        return [to_dict(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    return obj


def _config_class(tag: str):
    """The port's class for a ``__class__`` tag."""
    module, _, name = tag.rpartition(".")
    top, _, rest = module.partition(".")
    if top not in (_PACKAGE, _SHARED_PACKAGE) or not rest:
        raise ValueError(f"config class {tag!r} is not a {_PACKAGE} class")
    try:
        return getattr(importlib.import_module(f"{_PACKAGE}.{rest}"), name)
    except (ImportError, AttributeError) as e:
        raise ValueError(
            f"config class {tag!r} has no counterpart {_PACKAGE}.{rest}.{name}"
        ) from e


def _tuples(value: Any) -> Any:
    if isinstance(value, list):
        return tuple(_tuples(x) for x in value)
    return value


def from_dict(data: Any) -> Any:
    if isinstance(data, dict):
        if "__path__" in data:
            return Path(data["__path__"])
        if "__class__" in data:
            cls = _config_class(data["__class__"])
            kwargs = {
                k: from_dict(v) for k, v in data.items() if k != "__class__"
            }
            fields = {f.name: f for f in dataclasses.fields(cls)}
            return cls(**{
                # a file holds lists; tuple-typed fields get tuples back
                k: _tuples(v) if fields[k].type in ("tuple", tuple) else v
                for k, v in kwargs.items() if k in fields
            })
        return {k: from_dict(v) for k, v in data.items()}
    if isinstance(data, list):
        return [from_dict(x) for x in data]
    return data


def _float_text(x: float) -> str:
    if math.isnan(x):
        raise ValueError("a config value is NaN")
    if math.isinf(x):
        return "1.0e+999" if x > 0 else "-1.0e+999"
    text = repr(x)
    if "e" in text and "." not in text:
        text = text.replace("e", ".0e", 1)
    return text


def _json_text(data: Any, indent: str = "") -> str:
    """JSON for ``to_dict``'s output, floats written as PyYAML reads them."""
    inner = indent + "  "
    if isinstance(data, dict):
        if not data:
            return "{}"
        items = [f"{inner}{json.dumps(str(k))}: {_json_text(v, inner)}"
                 for k, v in data.items()]
        return "{\n" + ",\n".join(items) + f"\n{indent}}}"
    if isinstance(data, list):
        if not data:
            return "[]"
        items = [inner + _json_text(v, inner) for v in data]
        return "[\n" + ",\n".join(items) + f"\n{indent}]"
    if isinstance(data, float):
        return _float_text(data)
    if data is None or isinstance(data, (bool, int, str)):
        return json.dumps(data)
    raise TypeError(f"cannot write {type(data).__name__} to a config file")


def save_config(path, config) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write(_json_text(to_dict(config)) + "\n")


def load_config(path):
    """A config written by either package: JSON, or YAML through PyYAML."""
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        import yaml

        data = yaml.safe_load(text)
    return from_dict(data)
