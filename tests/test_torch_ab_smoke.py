"""profiling/ab_smoke.py on the CPU: the phase groups' seconds from
stamped lines, and a stand-in chip_smoke.py run and stamped."""

from craytracer_tpu_torch.profiling import ab_smoke


def test_group_seconds_from_stamped_lines():
    lines = ["    0.50 [device] NVIDIA H100", "    1.00 not a tag",
             "   10.00 [slice-f] 38 a", "   12.00 [slice-f] 39 b",
             "   30.00 [slice-l] 55 (a)", "   30.50 [slice-l] 55 (b)",
             "   31.00 [inverse] (a)", "   40.25 {\"ok\": true}",
             "no stamp"]
    groups, end = ab_smoke.group_seconds(lines)
    assert end == 40.25
    assert groups["1-36"] == 9.5
    assert groups["38-43 slice F"] == 20.0
    assert groups["55 slice L"] == 1.0
    assert groups["37 and the result"] == 9.25
    assert groups["44-48 slice I"] is None
    assert groups["56 slice M"] is None
    assert list(groups) == [name for name, _ in ab_smoke.GROUPS]


def test_run_smoke_stamps_each_line(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        "print('[device] card')\nprint('[slice-m] 56 (a) ok')\n"
        "print('[inverse] (a)')\nimport sys\nsys.exit(3)\n")
    log = tmp_path / "out.log"
    assert ab_smoke.run_smoke(str(tmp_path), str(log)) == 3
    lines = log.read_text().splitlines()
    assert [ln.split(maxsplit=1)[1] for ln in lines] == [
        "[device] card", "[slice-m] 56 (a) ok", "[inverse] (a)"]
    groups, end = ab_smoke.group_seconds(lines)
    assert groups["1-36"] >= 0 and groups["56 slice M"] >= 0
    assert groups["38-43 slice F"] is None and end >= 0
