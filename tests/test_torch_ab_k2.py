"""profiling/ab_k2.py's argument handling, on the CPU: what it refuses,
and the command lines it hands to the process that makes the inputs and
to each root's process (with the card's work stubbed out)."""

import os
import subprocess
from types import SimpleNamespace

import pytest

from craytracer_tpu_torch.profiling import ab_k2, ab_roots


@pytest.mark.parametrize("argv,msg", [([], "give at least one ROOT"),
                                      (["a", "--size", "0"], "positive"),
                                      (["a", "--size", "x"], "invalid int")])
def test_refuses(capsys, argv, msg):
    with pytest.raises(SystemExit) as e:
        ab_k2.main(argv)
    assert e.value.code == 2 and msg in capsys.readouterr().err


def _stub(monkeypatch, rc):
    seen = {}

    def run(cmd, **kw):
        seen["prepare"] = (cmd, kw["cwd"])
        return SimpleNamespace(returncode=rc, stderr="")

    def roots(script, roots_, extra=(), timeout=900):
        seen["roots"] = (script, list(roots_), tuple(extra))
        return None

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(ab_roots, "run_roots", roots)
    return seen


def test_hands_size_and_inputs_to_every_process(monkeypatch):
    seen = _stub(monkeypatch, 0)
    assert ab_k2.main(["p", ".", ".", "p", "--size", "256"]) == 1
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(ab_k2.__file__))))
    path = ab_k2._inputs_path(here)
    cmd, cwd = seen["prepare"]
    assert cwd == here and cmd[1:] == [
        "-m", "craytracer_tpu_torch.profiling.ab_k2", "--prepare",
        "--inputs", path, "--size", "256"]
    script, roots, extra = seen["roots"]
    assert script == ab_k2.__file__ and roots == ["p", ".", ".", "p"]
    assert extra == ("--inputs", path, "--size", "256")


def test_stops_when_the_inputs_fail(monkeypatch, capsys):
    seen = _stub(monkeypatch, 1)
    assert ab_k2.main(["."]) == 1
    assert "FAIL: making the inputs" in capsys.readouterr().out
    assert "roots" not in seen and "--size 512" in " ".join(
        seen["prepare"][0])
