"""The port's progress display, console logging and general helpers
(contrastyou_tpu_torch/indicator.py, loggers.py, utils/) held against the
JAX package's on the CPU: the postfix and ``log_result`` text of
``Indicator`` equal to JAX's (tqdm's postfix) on the same nested meter
statistics; the line written at close on a non-terminal and the redraws on
a terminal; the console level from ``LOG_LEVEL`` / ``LOGURU_LEVEL``, the
TRACE and SUCCESS levels and the colours; ``flatten_dict``, ``ntuple``,
``safe_save``, ``ignore_exception``, the one-hot helpers and
``fix_all_seed`` against JAX's."""
import io
import logging
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastyou_tpu import indicator as jindicator
from contrastyou_tpu import utils as jutils
from contrastyou_tpu_torch import loggers, utils
from contrastyou_tpu_torch.indicator import Indicator, format_value

STATS = [
    {"tra": {"sup": 0.25, "reg": 1.5e-5}},
    {"tra": {"sup": 12345.678, "reg": 0.0, "sup_dice": {"DSC1": 0.5, "DSC2": -0.0001,
                                                         "DSC_mean": 0.25}},
     "val": {"dice": {"DSC1": 0.123456}}, "name": "x"},
    {"pretrain": {"reg": float("nan")}, "a": {"b": {"c": {"d": 1, "e": "text"}}},
     **{f"m{i}": i / 7 for i in range(10)}},
]


class _Lines:
    def __init__(self):
        self.lines = []

    def info(self, msg, *args, **kw):
        self.lines.append(msg % args if args else msg)


@pytest.mark.parametrize("stats", STATS, ids=["train", "nested", "many"])
def test_postfix_and_log_result_equal_jax(stats, monkeypatch, caplog):
    rec = _Lines()
    monkeypatch.setattr(jindicator, "logger", rec)
    ref = jindicator.Indicator(range(3), disable=True)
    ours = Indicator(range(3), stream=io.StringIO())
    for force in (False, True):
        ref.set_postfix_statics(stats, force_update=force)
        ours.set_postfix_statics(stats, force_update=force)
        assert ours.postfix == ref.postfix
    ref.log_result("tra: ")
    with caplog.at_level(logging.INFO, logger="contrastyou_tpu_torch"):
        text = ours.log_result("tra: ")
    assert text == rec.lines[-1] and text in caplog.messages
    ref.close()


def test_update_every_caches_like_jax():
    ref = jindicator.Indicator(range(50), disable=True)
    ours = Indicator(range(50), stream=io.StringIO(), update_every=20)
    for i in range(45):
        s = {"tra": {"sup": float(i)}}
        ref.set_postfix_statics(s)
        ours.set_postfix_statics(s)
        assert ours.postfix == ref.postfix, i
    for v in (0, 1e-4, 5e4, 0.5, "text", None, np.float32(2.5)):
        assert format_value(v) == jindicator._fmt(v)


class _Tty(io.StringIO):
    def isatty(self):
        return True


def test_lines_on_a_terminal_and_elsewhere():
    plain = io.StringIO()
    ind = Indicator(range(12), desc="train 000", stream=plain)
    for it in ind:
        if it % 10 == 9 or it == 11:
            ind.set_postfix_statics({"tra": {"sup": 0.5, "reg": 0.25}}, force_update=it == 11)
    text = plain.getvalue()
    assert text.count("\n") == 1 and text.startswith("train 000: 12/12 [")
    assert text.rstrip().endswith("sup=0.500, reg=0.250]")
    tty = _Tty()
    ind = Indicator(range(3), desc="pretrain 001", stream=tty, mininterval=0.0)
    assert list(ind) == [0, 1, 2]
    out = tty.getvalue()
    assert out.count("\r") == 4 and "pretrain 001: 3/3" in out and "\n" not in out


def test_console_level_names_and_colours(monkeypatch):
    assert logging.getLevelName(loggers.TRACE) == "TRACE" == logging.getLevelName(5)
    assert logging.getLevelName(loggers.SUCCESS) == "SUCCESS" == logging.getLevelName(25)
    monkeypatch.delenv("LOG_LEVEL", raising=False)
    monkeypatch.delenv("LOGURU_LEVEL", raising=False)
    assert loggers.console_level() == logging.INFO
    monkeypatch.setenv("LOGURU_LEVEL", "SUCCESS")
    assert loggers.console_level() == 25
    monkeypatch.setenv("LOG_LEVEL", "trace")
    assert loggers.console_level() == 5
    monkeypatch.setenv("LOG_LEVEL", "30")
    assert loggers.console_level() == 30
    monkeypatch.setenv("LOG_LEVEL", "LOUD")
    with pytest.raises(ValueError, match="LOUD"):
        loggers.console_level()
    log = logging.getLogger("contrastyou_tpu_torch")
    level = log.level
    try:
        monkeypatch.setenv("LOG_LEVEL", "SUCCESS")
        plain, tty = io.StringIO(), _Tty()
        loggers.setup_logging(plain)
        child = logging.getLogger("contrastyou_tpu_torch.some.module")
        child.info("hidden")
        child.log(loggers.SUCCESS, "shown %d", 1)
        assert "hidden" not in plain.getvalue()
        assert "| SUCCESS  | contrastyou_tpu_torch.some.module:" in plain.getvalue()
        assert "shown 1" in plain.getvalue() and "\x1b[" not in plain.getvalue()
        loggers.setup_logging(tty)
        child.warning("careful")
        assert tty.getvalue().startswith("\x1b[33m") and "careful" in tty.getvalue()
        assert plain.getvalue().count("\n") == 1     # the first handler was replaced
    finally:
        for h in [h for h in log.handlers if getattr(h, "_console", False)]:
            log.removeHandler(h)
        log.setLevel(level)


def test_general_helpers_equal_jax(tmp_path):
    nested = {"a": {"b": 1, "c": {"d": [1, 2]}}, "e": 3}
    assert utils.flatten_dict(nested) == jutils.flatten_dict(nested)
    assert utils.flatten_dict(nested, sep=".") == jutils.flatten_dict(nested, sep=".")
    for n, x in ((3, 2), (2, "ab"), (2, [1, 2]), (4, (5,)), (2, range(3))):
        assert utils.ntuple(n)(x) == jutils.ntuple(n)(x)
    assert utils.class_name(1.0) == jutils.class_name(1.0) == "float"
    assert utils.path2Path("a/b") == jutils.path2Path("a/b")
    target = tmp_path / "deep" / "file.txt"
    utils.safe_save(lambda p: open(p, "w").write("hello"), target)
    assert target.read_text() == "hello" and [p.name for p in target.parent.iterdir()] == \
        ["file.txt"]
    with pytest.raises(RuntimeError):
        utils.safe_save(lambda p: (_ for _ in ()).throw(RuntimeError("x")), tmp_path / "y")
    assert list(tmp_path.glob("*.tmp")) == []
    with utils.ignore_exception(KeyError):
        raise KeyError("swallowed")
    with pytest.raises(ValueError):
        with utils.ignore_exception(KeyError):
            raise ValueError("kept")


def test_tensor_helpers_equal_jax():
    rng = np.random.default_rng(0)
    seg = rng.integers(0, 4, (2, 5, 6))
    logits = rng.normal(size=(2, 5, 6, 4)).astype(np.float32)
    probs = np.asarray(jnp.exp(logits) / jnp.exp(logits).sum(-1, keepdims=True))
    np.testing.assert_array_equal(utils.class2one_hot(torch.tensor(seg), 4).numpy(),
                                  np.asarray(jutils.class2one_hot(jnp.asarray(seg), 4)))
    np.testing.assert_array_equal(utils.logits2class(torch.tensor(logits)).numpy(),
                                  np.asarray(jutils.logits2class(jnp.asarray(logits))))
    np.testing.assert_array_equal(utils.probs2class(torch.tensor(probs)).numpy(),
                                  np.asarray(jutils.probs2class(jnp.asarray(probs))))
    np.testing.assert_array_equal(utils.probs2one_hot(torch.tensor(probs)).numpy(),
                                  np.asarray(jutils.probs2one_hot(jnp.asarray(probs))))
    for x in (probs, logits, np.asarray(jutils.class2one_hot(jnp.asarray(seg), 4))):
        assert utils.simplex(torch.tensor(x)) == jutils.simplex(jnp.asarray(x))
        assert utils.one_hot(torch.tensor(x)) == jutils.one_hot(jnp.asarray(x))


def test_fix_all_seed_equals_jax():
    jutils.fix_all_seed(12345678901)
    ref = (random.random(), np.random.rand())
    utils.fix_all_seed(12345678901)
    assert (random.random(), np.random.rand()) == ref
