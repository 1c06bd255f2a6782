"""Config loading: YAML files merged left to right, then dotted CLI
overrides (counterpart of contrastyou_tpu/configure/config.py).

``-p a.yaml b.yaml`` merges the files; ``-o a.b=c`` overrides an existing
key (or a :data:`RUNTIME_KEYS` key), ``+a.b=c`` adds one, ``~a.b`` deletes
one. Nothing here needs PyYAML: the files are read by :mod:`.yaml11` (the
block-YAML subset of ``config/`` and ``opt/``, scalars resolved as PyYAML's
``safe_load`` resolves them), an override value is parsed by JAX's rule on
the same reader (:func:`parse_value`), and :func:`yaml_write` writes a
run's ``config.yaml``.
"""
from __future__ import annotations

import argparse
import copy
import math
import re
from pathlib import Path
from typing import Any, Iterable, List, Mapping, Optional, Sequence

from . import yaml11

__all__ = ["merge", "yaml_load", "yaml_write", "parse_value", "apply_overrides",
           "ConfigParser"]


def merge(base: Mapping, override: Mapping) -> dict:
    """Recursive merge; mappings merge, everything else is replaced."""
    out = copy.deepcopy(dict(base))
    for k, v in override.items():
        if isinstance(out.get(k), Mapping) and isinstance(v, Mapping):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def yaml_load(path) -> dict:
    """The mapping of the YAML file ``path`` (an empty file: ``{}``), read
    by :func:`.yaml11.load`, which raises with the file and line on YAML
    outside its subset."""
    return dict(yaml11.load(Path(path).read_text(), str(path)) or {})


_PLAIN = re.compile(r"[A-Za-z_][A-Za-z0-9_.\-]*")
_YAML_WORDS = {"null", "Null", "NULL", "true", "True", "TRUE", "false", "False", "FALSE",
               "yes", "Yes", "YES", "no", "No", "NO", "on", "On", "ON", "off", "Off", "OFF",
               "y", "Y", "n", "N", "~"}


def _yaml_scalar(v) -> str:
    """A YAML 1.1 scalar that ``yaml.safe_load`` reads back as ``v``
    (floats as PyYAML writes them: ``repr``, a ``.0`` before a bare
    exponent)."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    text = str(v)
    if _PLAIN.fullmatch(text) and text not in _YAML_WORDS:
        return text
    return "'" + text.replace("'", "''") + "'"


def _yaml_lines(node, indent: int) -> List[str]:
    pad = " " * indent
    lines: List[str] = []
    if isinstance(node, Mapping):
        for k, v in node.items():
            key = _yaml_scalar(k)
            if isinstance(v, (Mapping, list, tuple)) and len(v):
                lines.append(f"{pad}{key}:")
                lines += _yaml_lines(v, indent + (2 if isinstance(v, Mapping) else 0))
            else:
                lines.append(f"{pad}{key}: {_yaml_flat(v)}")
    else:
        for v in node:
            if isinstance(v, (Mapping, list, tuple)) and len(v):
                sub = _yaml_lines(v, indent + 2)
                lines.append(f"{pad}- {sub[0].lstrip()}")
                lines += sub[1:]
            else:
                lines.append(f"{pad}- {_yaml_flat(v)}")
    return lines


def _yaml_flat(v) -> str:
    if isinstance(v, Mapping):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _yaml_scalar(v)


def yaml_write(config: Mapping, save_dir, filename: str = "config.yaml") -> str:
    """Write ``config`` (nested mappings, lists, scalars) as block YAML to
    ``save_dir/filename``; returns the path."""
    Path(save_dir).mkdir(parents=True, exist_ok=True)
    target = Path(save_dir) / filename
    target.write_text("\n".join(_yaml_lines(config, 0)) + "\n")
    return str(target)


def parse_value(raw: str) -> Any:
    """An override's value by JAX's rule (contrastyou_tpu/configure/config.py
    ``_parse_value``): the token read as a YAML 1.1 document (a scalar, a
    nested flow list or map, a quoted string; ``yes``/``on`` are bools,
    ``None`` a string, ``010`` 8, ``2:30`` 150, ``.inf`` a float); a string
    result is retried as an int, then a float (so ``1e-3`` is 0.001); a
    token that is not valid YAML stays the raw string. A token using YAML
    that :mod:`.yaml11` leaves out (an anchor, a tag, ...) raises
    ``ValueError``."""
    try:
        value = yaml11.load(raw, "<override>")
    except yaml11.YAMLUnsupported as e:
        raise ValueError(f"override value {raw!r}: {e}") from e
    except yaml11.YAMLSyntaxError:
        return raw
    if isinstance(value, str):
        for conv in (int, float):
            try:
                return conv(value)
            except ValueError:
                pass
    return value


def _set(cfg: dict, dotted: str, value, allow_new: bool) -> None:
    parts = dotted.split(".")
    node = cfg
    for part in parts[:-1]:
        if part not in node:
            if not allow_new:
                raise KeyError(f"key '{dotted}' not in config; prefix with '+' to add it")
            node[part] = {}
        node = node[part]
        if not isinstance(node, dict):
            raise KeyError(f"'{dotted}': '{part}' is a leaf")
    if parts[-1] not in node and not allow_new:
        raise KeyError(f"key '{dotted}' not in config; prefix with '+' to add it")
    node[parts[-1]] = value


#: keys ``-o`` may set though the files lack them: ``Trainer.device`` (the
#: reference strips it from the section before the trainer sees it),
#: ``Trainer.device_cache`` and ``Inference.tta`` (off when absent),
#: ``Trainer.unroll_steps`` (1 when absent)
RUNTIME_KEYS = ("Trainer.device", "Trainer.device_cache", "Trainer.unroll_steps",
                "Inference.tta")


def apply_overrides(config: Mapping, tokens: Iterable[str]) -> dict:
    out = copy.deepcopy(dict(config))
    for tok in tokens:
        if tok.startswith("~"):
            parts = tok[1:].split(".")
            node = out
            for p in parts[:-1]:
                node = node[p]
            del node[parts[-1]]
        elif "=" in tok:
            key, raw = tok.split("=", 1)
            key_ = key.lstrip("+")
            _set(out, key_, parse_value(raw), key.startswith("+") or key_ in RUNTIME_KEYS)
        else:
            raise ValueError(f"malformed override '{tok}' (want key=value, +key=value or ~key)")
    return out


class ConfigParser:
    """``prog -p base.yaml hook.yaml -o A.b=1 +C.d=2 ~E``; without ``-p``
    the ``default`` mapping is the base."""

    def __init__(self, default: Optional[Mapping] = None):
        self.default = dict(default or {})

    def parse(self, argv: Sequence[str]) -> dict:
        ap = argparse.ArgumentParser()
        ap.add_argument("-p", "--path", nargs="*", default=[],
                        help="yaml config paths merged left to right")
        ap.add_argument("-o", "--opt", nargs="*", default=[],
                        help="dotted overrides: a.b=c, +new.key=v, ~delete.key")
        ns, _unknown = ap.parse_known_args(list(argv))
        base: dict = {} if ns.path else copy.deepcopy(self.default)
        for p in ns.path:
            base = merge(base, yaml_load(Path(p)))
        return apply_overrides(base, ns.opt)
