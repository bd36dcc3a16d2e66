"""The A/B scripts' shared runner and report
(craytracer_tpu_torch/profiling/ab_roots.py), on the CPU: a stand-in
script run once per root in a fresh process, the report's hash verdict,
and each A/B script started both ways it is started (`python -m` for the
run, by file path for each root's child process)."""

import json
import os
import subprocess
import sys

import pytest

from craytracer_tpu_torch.profiling import ab_roots

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STANDIN = """import json, os, sys
root = sys.argv[sys.argv.index("--one") + 1]
print("noise")
print(json.dumps({"root": root, "cwd": os.getcwd(), "extra": sys.argv[3:],
                  "case": {"ms": float(open("ms").read()), "hash":
                           open("hash").read()}}))
"""


def _roots(tmp_path, specs):
    script = tmp_path / "standin.py"
    script.write_text(STANDIN)
    roots = []
    for k, (ms, h) in enumerate(specs):
        root = tmp_path / f"root{k}"
        root.mkdir()
        (root / "ms").write_text(str(ms))
        (root / "hash").write_text(h)
        roots.append(str(root))
    return str(script), roots


@pytest.mark.parametrize("hashes,same", [(("a", "a", "a"), True),
                                         (("a", "b", "a"), False)])
def test_run_roots_and_report(tmp_path, capsys, hashes, same):
    script, roots = _roots(tmp_path, zip((2.0, 1.0, 3.0), hashes))
    results = ab_roots.run_roots(script, [roots[0], roots[1], roots[2],
                                          roots[0]], ("--x", "1"))
    assert [r["root"] for r in results] == roots + roots[:1]
    assert all(r["cwd"] == r["root"] and r["extra"] == ["--x", "1"]
               for r in results)
    capsys.readouterr()
    got = ab_roots.report("t", "card", results, [
        ("case", lambda r: r["case"]["ms"], lambda r: r["case"]["hash"]),
        ("unhashed", lambda r: r["case"]["ms"], None)])
    assert got is same
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and lines[0].startswith("[t] card, case, ")
    assert f"{os.path.relpath(roots[1])} 0.5000" in lines[0]
    assert f"{os.path.relpath(roots[2])} 1.5000" in lines[0]
    assert "output hashes" not in lines[1]
    out = tmp_path / "out.json"
    ab_roots.write_out(str(out), "card", results)
    assert json.loads(out.read_text())["runs"] == results


def test_run_roots_stops_at_a_failing_root(tmp_path, capsys):
    script, roots = _roots(tmp_path, [(1.0, "a")])
    os.remove(os.path.join(roots[0], "ms"))
    assert ab_roots.run_roots(script, roots) is None
    assert "FAIL" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["ab_k1", "ab_bvh4", "ab_render",
                                  "ab_k2"])
def test_ab_scripts_start_as_module_and_by_path(name):
    path = os.path.join(REPO, "craytracer_tpu_torch", "profiling",
                        f"{name}.py")
    for cmd in ([sys.executable, "-m", f"craytracer_tpu_torch.profiling."
                 f"{name}", "--help"], [sys.executable, path, "--help"]):
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert "ROOT" in proc.stdout or "roots" in proc.stdout
