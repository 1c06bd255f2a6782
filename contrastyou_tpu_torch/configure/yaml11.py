"""A reader of the YAML 1.1 subset that ``config/`` and ``opt/`` use, with
scalars resolved as PyYAML's ``safe_load`` resolves them (the JAX package
reads its presets with PyYAML; the card's machine has none).

The subset:

- block mappings, nested by indentation (spaces only), ``key: value`` or
  ``key:`` followed by a more indented block or by a block sequence at the
  key's own indentation;
- block sequences (``- item``, ``- key: value`` opening a mapping inside
  the item);
- flow sequences and flow mappings on one line, nested (``[ Conv5,
  Up_conv2 ]``, ``[1, [2, 3]]``, ``{a: 1}``);
- full-line and trailing ``#`` comments;
- plain scalars, single-quoted (``''`` for a quote) and double-quoted
  (backslash escapes) scalars.

Plain scalars resolve by YAML 1.1's implicit types, PyYAML's regular
expressions and constructors: ``yes|no|on|off|true|false`` in their three
case forms are bools (``y`` and ``n`` are strings); ``~``, ``null`` and the
empty scalar are null (``None`` is a string); ints in decimal, ``0b``,
``0x``, octal with a leading ``0`` (``010`` is 8), with ``_`` separators and
sexagesimal ``a:b`` (``2:30`` is 150); floats need a ``.`` and a signed
exponent (``1e-4`` and ``1.0e5`` are strings, ``0.0000005`` a float),
``.inf`` and ``.nan`` count; ``YYYY-MM-DD`` dates and timestamps.

Anything outside the subset (anchors, aliases, tags, block scalars ``|`` and
``>``, directives, document markers, a plain scalar continued on the next
line, a flow collection over several lines, tabs in indentation) raises
:class:`YAMLUnsupported` naming the source and line, rather than being
guessed; malformed text raises :class:`YAMLSyntaxError`.
"""
from __future__ import annotations

import datetime
import re
from typing import Any, List, Optional

__all__ = ["YAMLSyntaxError", "YAMLUnsupported", "resolve_plain", "load"]


class YAMLSyntaxError(ValueError):
    """Malformed YAML (what PyYAML reports as a ``YAMLError``)."""

    def __init__(self, message: str, source: str = "<string>", line: Optional[int] = None):
        where = source if line is None else f"{source}:{line}"
        super().__init__(f"{where}: {message}")


class YAMLUnsupported(YAMLSyntaxError):
    """YAML this reader leaves out (see the module docstring)."""


# --- scalars: PyYAML's implicit resolvers and safe constructors -------------

_BOOL = re.compile(r'''^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$''', re.X)
_FLOAT = re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$''', re.X)
_INT = re.compile(r'''^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X)
_NULL = re.compile(r'''^(?: ~
                    |null|Null|NULL
                    | )$''', re.X)
_TIMESTAMP_IMPLICIT = re.compile(r'''^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$''', re.X)
_TIMESTAMP = re.compile(r'''^(?P<year>[0-9][0-9][0-9][0-9])
                -(?P<month>[0-9][0-9]?)
                -(?P<day>[0-9][0-9]?)
                (?:(?:[Tt]|[ \t]+)
                (?P<hour>[0-9][0-9]?)
                :(?P<minute>[0-9][0-9])
                :(?P<second>[0-9][0-9])
                (?:\.(?P<fraction>[0-9]*))?
                (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
                (?::(?P<tz_minute>[0-9][0-9]))?))?)?$''', re.X)
_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}


def _sexagesimal(parts, cast):
    value, base = cast(0), 1
    for digit in reversed([cast(p) for p in parts]):
        value += digit * base
        base *= 60
    return value


def _int(text: str) -> int:
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value.split(":"), int)
    return sign * int(value)


def _float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value.split(":"), float)
    return sign * float(value)


def _timestamp(text: str):
    v = _TIMESTAMP.match(text).groupdict()
    year, month, day = int(v["year"]), int(v["month"]), int(v["day"])
    if not v["hour"]:
        return datetime.date(year, month, day)
    fraction = int((v["fraction"] or "")[:6].ljust(6, "0")) if v["fraction"] else 0
    tzinfo = None
    if v["tz_sign"]:
        delta = datetime.timedelta(hours=int(v["tz_hour"]), minutes=int(v["tz_minute"] or 0))
        tzinfo = datetime.timezone(-delta if v["tz_sign"] == "-" else delta)
    elif v["tz"]:
        tzinfo = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(v["hour"]), int(v["minute"]),
                             int(v["second"]), fraction, tzinfo=tzinfo)


def resolve_plain(text: str, source: str = "<string>", line: Optional[int] = None) -> Any:
    """A plain (unquoted) scalar's value under YAML 1.1's implicit types, as
    PyYAML's ``safe_load`` resolves and constructs it."""
    if _BOOL.match(text):
        return _BOOL_VALUES[text.lower()]
    if _FLOAT.match(text):
        return _float(text)
    if _INT.match(text):
        return _int(text)
    if _NULL.match(text):
        return None
    if _TIMESTAMP_IMPLICIT.match(text):
        return _timestamp(text)
    if text in ("<<", "="):
        # PyYAML resolves them to the merge and value tags, which safe_load cannot construct
        raise YAMLSyntaxError(f"the plain scalar {text!r} has no safe constructor", source, line)
    return text


# --- the text -----------------------------------------------------------------

_UNSUPPORTED_START = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
                      ">": "block scalars", "%": "directives", "?": "complex keys"}
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Text:
    """One line's text (after its indentation), scanned left to right."""

    def __init__(self, text: str, source: str, line: int, more: bool = True):
        # ``more``: whether the source goes on after this line (else what
        # would continue on the next line is malformed, not unsupported)
        self.s, self.i, self.source, self.line, self.more = text, 0, source, line, more

    def error(self, message: str, cls=YAMLSyntaxError):
        return cls(message, self.source, self.line)

    def continued(self, what: str):
        """The error of ``what`` running past the end of the line."""
        cls = YAMLUnsupported if self.more else YAMLSyntaxError
        return cls(f"{what} continued on the next line", self.source, self.line)

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < len(self.s) else ""

    def skip_spaces(self) -> None:
        while self.peek() in (" ", "\t"):
            self.i += 1

    def at_comment_or_end(self) -> bool:
        """Whether only spaces and a comment remain."""
        j = self.i
        while j < len(self.s) and self.s[j] in " \t":
            j += 1
        # a comment follows a space, or directly a token (a quote, a bracket)
        return j == len(self.s) or (self.s[j] == "#" and (j == self.i or self.s[j - 1] in " \t"))

    def check_start(self, flow: bool) -> None:
        """Raise unless a plain scalar may start here (PyYAML's
        ``check_plain``): an indicator starts one only before a non-space,
        and then only ``-``, or ``?`` and ``:`` outside a flow collection."""
        c, nxt = self.peek(), self.peek(1)
        if c == "" or c not in "-?:,[]{}#&*!|>'\"%@`":
            return
        if nxt not in ("", " ", "\t") and (c == "-" or (not flow and c in "?:")):
            return
        if c in _UNSUPPORTED_START:
            raise self.error(f"{_UNSUPPORTED_START[c]} ({c!r}) are not read", YAMLUnsupported)
        raise self.error(f"a plain scalar cannot start with {c!r}")

    # quoted scalars
    def single_quoted(self) -> str:
        self.i += 1
        out = []
        while True:
            c = self.peek()
            if c == "":
                raise self.continued("a single-quoted scalar")
            if c == "'":
                if self.peek(1) == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            out.append(c)
            self.i += 1

    def double_quoted(self) -> str:
        self.i += 1
        out = []
        while True:
            c = self.peek()
            if c == "":
                raise self.continued("a double-quoted scalar")
            if c == '"':
                self.i += 1
                return "".join(out)
            if c == "\\":
                e = self.peek(1)
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 2
                elif e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = self.s[self.i + 2:self.i + 2 + n]
                    if len(digits) != n or not re.fullmatch(r"[0-9A-Fa-f]+", digits):
                        raise self.error(f"bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    self.i += 2 + n
                elif e == "":
                    raise self.continued("a double-quoted scalar")
                else:
                    raise self.error(f"unknown escape \\{e}")
                continue
            out.append(c)
            self.i += 1

    # plain scalars
    def plain(self, flow: bool) -> str:
        """A plain scalar: to the end of the line or a comment, or in a flow
        collection to ``,?[]{}`` or a ``:`` before a space or one of them."""
        start = self.i
        end = self.i
        stops = ",?[]{}" if flow else ""
        while True:
            c = self.peek()
            if c == "":
                break
            if c in " \t":
                if self.at_comment_or_end():
                    break
                self.i += 1
                continue
            nxt = self.peek(1)
            if c == ":" and (nxt in (" ", "\t", "") or (flow and nxt in ",[]{}")):
                break
            if flow and c in stops:
                break
            self.i += 1
            end = self.i
        self.i = end
        return self.s[start:end]

    def scalar(self, flow: bool) -> Any:
        """The value of the scalar here."""
        c = self.peek()
        if c == "'":
            return self.single_quoted()
        if c == '"':
            return self.double_quoted()
        self.check_start(flow)
        return resolve_plain(self.plain(flow), self.source, self.line)

    # flow collections
    def flow_node(self) -> Any:
        self.skip_spaces()
        c = self.peek()
        if c == "[":
            return self.flow_sequence()
        if c == "{":
            return self.flow_mapping()
        return self.scalar(flow=True)

    def _flow_end(self, what: str) -> None:
        if self.peek() == "":
            raise self.continued(f"a flow {what}")

    def flow_sequence(self) -> list:
        self.i += 1
        out: list = []
        while True:
            self.skip_spaces()
            self._flow_end("sequence")
            if self.peek() == "]":
                self.i += 1
                return out
            item = self.flow_node()
            self.skip_spaces()
            if self.peek() == ":":            # [a: 1] is [{a: 1}]
                self.i += 1
                item = {item: self._flow_value("sequence", "]")}
                self.skip_spaces()
            out.append(item)
            self._flow_end("sequence")
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                raise self.error(f"expected ',' or ']' in a flow sequence, got {self.peek()!r}")

    def _flow_value(self, what: str, close: str) -> Any:
        self.skip_spaces()
        self._flow_end(what)
        return None if self.peek() in (",", close) else self.flow_node()

    def flow_mapping(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            self.skip_spaces()
            self._flow_end("mapping")
            if self.peek() == "}":
                self.i += 1
                return out
            key = self.flow_node()
            self.skip_spaces()
            value = None
            if self.peek() == ":":
                self.i += 1
                value = self._flow_value("mapping", "}")
                self.skip_spaces()
            out[_hashable(key, self)] = value
            self._flow_end("mapping")
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                raise self.error(f"expected ',' or '}}' in a flow mapping, got {self.peek()!r}")

    def node_to_end(self) -> Any:
        """The flow collection or scalar that fills the rest of the line."""
        c = self.peek()
        value = (self.flow_node() if c in "[{" else self.scalar(flow=False))
        if not self.at_comment_or_end():
            rest = self.s[self.i:].strip()
            if rest.startswith(":"):
                raise self.error("mapping values are not allowed here")
            raise self.error(f"unexpected {rest!r} after a value")
        return value

    def mapping_key(self) -> Optional[Any]:
        """Reads ``key:`` when the line here is ``key: ...`` (a ``(key,)``
        tuple); else leaves the position and returns None."""
        save = self.i
        c = self.peek()
        if c in ("", "[", "{") or _is_item(self.s[self.i:]):
            return None
        if c == "'":
            key = self.single_quoted()
        elif c == '"':
            key = self.double_quoted()
        else:
            self.check_start(flow=False)
            text = self.plain(flow=False)
            if not text:
                return None
            key = resolve_plain(text, self.source, self.line)
        self.skip_spaces()
        if self.peek() != ":" or self.peek(1) not in (" ", "\t", ""):
            self.i = save
            return None
        self.i += 1
        return (_hashable(key, self),)


def _hashable(key, text: _Text):
    try:
        hash(key)
    except TypeError:
        raise text.error(f"unhashable mapping key {key!r}") from None
    return key


class _Line:
    __slots__ = ("number", "indent", "text")

    def __init__(self, number: int, indent: int, text: str):
        self.number, self.indent, self.text = number, indent, text


def _lines(source_text: str, source: str) -> List[_Line]:
    out = []
    for number, raw in enumerate(source_text.splitlines(), 1):
        body = raw.lstrip(" ")
        if not body.strip() or body.lstrip().startswith("#"):
            continue
        if body[0] == "\t":
            raise YAMLUnsupported("a tab in the indentation", source, number)
        if raw.startswith(("---", "...")) and raw[3:4] in ("", " ", "\t"):
            raise YAMLUnsupported("document markers are not read", source, number)
        if raw.startswith("%"):
            # a directive needs a document after it
            cls = YAMLUnsupported if "\n" in source_text.strip() else YAMLSyntaxError
            raise cls("directives are not read", source, number)
        out.append(_Line(number, len(raw) - len(body), body.rstrip()))
    return out


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith(("- ", "-\t"))


class _Parser:
    def __init__(self, lines: List[_Line], source: str):
        self.lines, self.k, self.source = lines, 0, source

    def peek(self) -> Optional[_Line]:
        return self.lines[self.k] if self.k < len(self.lines) else None

    def text(self, line: _Line) -> _Text:
        return _Text(line.text, self.source, line.number, more=line is not self.lines[-1])

    def no_continuation(self, parent: int) -> None:
        """A line deeper than the enclosing collection (``parent``) right
        after a scalar would continue it."""
        nxt = self.peek()
        if nxt is not None and nxt.indent > parent:
            raise YAMLUnsupported("a scalar continued on the next line (multi-line scalars "
                                  "are not read)", self.source, nxt.number)

    def block(self, parent: int) -> Any:
        """The node that starts at the next line, inside a collection at
        indentation ``parent`` (-1 at the top)."""
        line = self.peek()
        if _is_item(line.text):
            return self.sequence(line.indent)
        if self.text(line).mapping_key() is not None:
            return self.mapping(line.indent)
        self.k += 1
        value = self.text(line).node_to_end()
        self.no_continuation(parent)
        return value

    def value_after(self, indent: int, text: _Text) -> Any:
        """The value of the ``key:`` at ``indent`` whose rest is ``text``."""
        if not text.at_comment_or_end():
            text.skip_spaces()
            value = text.node_to_end()
            self.no_continuation(indent)
            return value
        nxt = self.peek()
        if nxt is None or nxt.indent < indent:
            return None
        if nxt.indent > indent:
            return self.block(indent)
        # ``key:`` then ``- a`` at the key's own column
        return self.sequence(indent) if _is_item(nxt.text) else None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            line = self.peek()
            if line is None or line.indent < indent or (
                    line.indent == indent and _is_item(line.text)):
                return out
            if line.indent > indent:
                raise YAMLSyntaxError("bad indentation of a mapping entry", self.source,
                                      line.number)
            text = self.text(line)
            key = text.mapping_key()
            if key is None:
                raise YAMLSyntaxError(f"expected 'key: value', got {line.text!r}", self.source,
                                      line.number)
            self.k += 1
            out[key[0]] = self.value_after(indent, text)

    def sequence(self, indent: int) -> list:
        out: list = []
        while True:
            line = self.peek()
            if line is None or line.indent < indent or (
                    line.indent == indent and not _is_item(line.text)):
                return out
            if line.indent > indent:
                raise YAMLSyntaxError("bad indentation of a sequence entry", self.source,
                                      line.number)
            rest = line.text[1:]
            body = rest.lstrip(" \t")
            if not body or body.startswith("#"):
                self.k += 1
                nxt = self.peek()
                out.append(self.block(indent) if nxt is not None and nxt.indent > indent
                           else None)
                continue
            # the item's content is read as a line of its own at its column
            self.lines[self.k] = _Line(line.number, indent + 1 + len(rest) - len(body), body)
            out.append(self.block(indent))


def load(text: str, source: str = "<string>") -> Any:
    """The YAML document ``text`` (see the module docstring for the subset);
    an empty document is None. ``source`` names it in errors."""
    lines = _lines(text, source)
    if not lines:
        return None
    parser = _Parser(lines, source)
    value = parser.block(-1)
    extra = parser.peek()
    if extra is not None:
        raise YAMLSyntaxError(f"unexpected {extra.text!r} after the document", source,
                              extra.number)
    return value
