"""Config loading: YAML files merged left to right, then dotted CLI
overrides (counterpart of contrastyou_tpu/configure/config.py).

``-p a.yaml b.yaml`` merges the files (PyYAML, imported only when a file is
read); ``-o a.b=c`` overrides an existing key (or a :data:`RUNTIME_KEYS`
key), ``+a.b=c`` adds one, ``~a.b`` deletes one. Override values are parsed
without PyYAML, so a run configured in code plus overrides needs no YAML
installation.
"""
from __future__ import annotations

import argparse
import copy
from pathlib import Path
from typing import Any, Iterable, Mapping, Optional, Sequence

__all__ = ["merge", "yaml_load", "parse_value", "apply_overrides", "ConfigParser"]


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
    import yaml
    with open(path) as f:
        return dict(yaml.safe_load(f) or {})


def parse_value(raw: str) -> Any:
    """YAML-style scalar or flow list: null/true/false, int, float, ``[a,
    b]``, else the (unquoted) string."""
    s = raw.strip()
    if s in ("", "~", "null", "Null", "NULL", "None"):
        return None
    if s in ("true", "True", "TRUE"):
        return True
    if s in ("false", "False", "FALSE"):
        return False
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        return [parse_value(p) for p in inner.split(",")] if inner else []
    for conv in (int, float):
        try:
            return conv(s)
        except ValueError:
            pass
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    return s


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


#: keys ``-o`` may set though the files lack them: the reference strips these
#: from the section before the trainer sees it
RUNTIME_KEYS = ("Trainer.device",)


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
