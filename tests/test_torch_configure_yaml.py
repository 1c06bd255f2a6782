"""The port's config reader against PyYAML and JAX's override parser.

``contrastyou_tpu_torch/configure/yaml11.py`` reads the YAML of ``config/``
and ``opt/`` without PyYAML; ``parse_value`` parses an ``-o`` token by JAX's
``_parse_value`` rule (``yaml.safe_load``, then an int / float retry of a
string). Here every preset file is held to ``yaml.safe_load`` and a table of
override tokens to JAX's parser, value and type.
"""
from __future__ import annotations

import datetime
import math
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from contrastyou_tpu.configure.config import ConfigParser as JaxConfigParser
from contrastyou_tpu.configure.config import _parse_value as jax_parse_value
from contrastyou_tpu_torch.configure import yaml11
from contrastyou_tpu_torch.configure.config import parse_value, yaml_load, yaml_write
from contrastyou_tpu_torch.main import parse_config

REPO = Path(__file__).resolve().parents[1]
YAML_FILES = sorted([*REPO.glob("config/*.yaml"), *REPO.glob("config/hooks/*.yaml"),
                     *REPO.glob("opt/*.yaml")])

#: override tokens: the ten on which the old parser disagreed with JAX's
#: first, then YAML 1.1's other scalar forms, flow collections and quotes
TOKENS = [
    "yes", "no", "on", "off", "None", "0x10", "2:30", ".inf", "[1,[2,3]]", "{a: 1}",
    "Yes", "NO", "On", "OFF", "y", "n", "Y", "N", "true", "False", "TRUE", "tRue",
    "~", "null", "Null", "NULL", "", "none",
    "0", "-0", "+1", "-17", "010", "09", "0o10", "0b101", "-0x1F", "1_000", "1:30",
    "12:34:56", "1:60", "60:00",
    "1.0", "3.", "-.5", "+0.5", "1_0.5", "0.0000005", "1e-3", "1e-4", "1.0e5", "1.5e-3",
    "1E5", "1.0e+5", "1:30.5", "-.inf", "+.Inf", ".nan", ".NaN", "inf", "nan", "infinity",
    "2020-01-01", "2020-1-1", "2001-12-14t21:59:43.10-05:00", "2001-12-14 21:59:43.10",
    "abc", "a b", "a:b", "a: b", "a#b", "a #b", "x=y", "=", "<<", "Conv5", "Up_conv2",
    "[]", "{}", "[a, b]", "[ Conv5, Up_conv2 ]", "[0.1, 0.05]", "[1]", "[1,2,]",
    "{a: [1, {b: 2}]}", "[a: 1]", "{a:1}", "[1:30]",
    "'5'", '"5"', "'a b'", "'it''s'", '"a\\tb"', '"\\x41"', "''", '""', "'yes'", '"1e-3"',
    "- 1", "-", ":", ",", "[1, 2", '"open', "a: b: c", "]", "@x", "`x", ",a",
]


def _same(a, b) -> bool:
    if type(a) is not type(b):
        return False
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("token", TOKENS, ids=[repr(t) for t in TOKENS])
def test_parse_value_agrees_with_jax(token):
    """The port's override value equals JAX's, of the same type (nested
    lists and maps element by element through ``==``)."""
    want, got = jax_parse_value(token), parse_value(token)
    assert _same(got, want), (token, got, want)
    if isinstance(want, (list, dict)):
        assert repr(got) == repr(want)


@pytest.mark.parametrize("token", ["&a 1", "*a", "!!str 1", "| x", "? a"])
def test_parse_value_refuses_unsupported_yaml(token):
    """A token using YAML the reader leaves out raises instead of parsing to
    another value than JAX's."""
    with pytest.raises(ValueError, match="override value"):
        parse_value(token)


@pytest.mark.parametrize("path", YAML_FILES, ids=[str(p.relative_to(REPO)) for p in YAML_FILES])
def test_yaml_files_load_as_pyyaml_loads_them(path):
    want = yaml.safe_load(path.read_text()) or {}
    got = yaml_load(path)
    assert got == want and repr(got) == repr(want)


def test_every_preset_file_is_read():
    assert len(YAML_FILES) == 36


DOCUMENTS = [
    "a:\n- 1\n- 2\nb: 3\n",
    "- a: 1\n  b: [1, {c: d}]\n- x\n-\n  - 7\n",
    "k: 'it''s' # comment\nj: \"a\\tb\"\n",
    "a:\n  b:\n    c: 1e-4\n  d: .5\nz: -.inf\n",
    "key:\n  - a\n  - b: 2\n    c: 3\n",
    "a:\n\n  b: 1   # trailing\n# full line\nc: [ x , y ]\n",
    "1: one\ntrue: yes\nnull: ~\n",
    "x: y z\n'q k': \"v\"\n",
]


@pytest.mark.parametrize("text", DOCUMENTS)
def test_block_subset_matches_pyyaml(text):
    assert repr(yaml11.load(text)) == repr(yaml.safe_load(text))


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: &x 2\n", 2), ("a: !!str 1\n", 1), ("a: |\n  x\n", 1), ("a: >\n  x\n", 1),
    ("a: 1\nb: *x\n", 2), ("---\na: 1\n", 1), ("a: [1,\n  2]\n", 1), ("a: x\n  y\n", 2),
    ("a:\n\tb: 1\n", 2), ("%YAML 1.1\n---\na: 1\n", 1),
])
def test_unsupported_yaml_raises_with_file_and_line(tmp_path, text, line):
    path = tmp_path / "preset.yaml"
    path.write_text(text)
    with pytest.raises(yaml11.YAMLUnsupported, match=rf"preset\.yaml:{line}: "):
        yaml_load(path)


def test_malformed_yaml_raises_with_file_and_line(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("a: 1\nb: c: d\n")
    with pytest.raises(yaml11.YAMLSyntaxError, match=r"bad\.yaml:2: "):
        yaml_load(path)


def test_yaml_write_reads_back(tmp_path):
    """A run's ``config.yaml`` (the port's writer) reads back equal, with
    PyYAML and with the port's reader."""
    config = {"a": {"b": [1, 2.5, "x y"], "c": None, "d": True, "e": "yes", "f": "1e-4",
                    "g": {"h": [{"i": 1, "j": [3]}]}, "k": [], "l": {}},
              "m": float("inf"), "n": "it's", "o": datetime.date(2020, 1, 1).isoformat()}
    path = yaml_write(config, tmp_path)
    assert yaml_load(path) == yaml.safe_load(Path(path).read_text()) == config


ARGV = ["-p", str(REPO / "config/base.yaml"), str(REPO / "config/hooks/udaiic.yaml"),
        "-o", "Trainer.name=semi", "Optim.lr=1e-4", "+Trainer.profile=yes",
        "Data.labeled_scan_num=2", "+Inference.tta=off"]


def test_parse_config_with_presets_equals_jax():
    """``-p`` presets and ``-o`` overrides configure the run as JAX's parser
    does (the port's runtime keys aside)."""
    want = JaxConfigParser().parse(ARGV).to_dict()
    assert parse_config(ARGV) == want


def test_presets_parse_with_pyyaml_and_jax_blocked():
    """``-p`` runs where neither PyYAML nor jax can be imported, and imports
    neither."""
    code = ("import sys, json\n"
            "sys.modules['yaml'] = None\n"
            "sys.modules['jax'] = None\n"
            "from contrastyou_tpu_torch.main import parse_config\n"
            f"config = parse_config({ARGV!r})\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('yaml', 'jax', "
            "'contrastyou_tpu') and sys.modules[m] is not None], 'imported'\n"
            "print(json.dumps(config, sort_keys=True))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120,
                         capture_output=True, text=True).stdout
    import json
    assert json.loads(out) == json.loads(json.dumps(parse_config(ARGV), sort_keys=True))
