"""The port's probe programs (parallel_gps_torch/probes/) through their
command lines on the CPU: the records they print and write, and their
default device."""
import json

import pytest
import torch

from parallel_gps_torch.probes import attrib, common, dma, grid

torch.set_num_threads(1)


PROBES = {"dma": dma, "attrib": attrib, "grid": grid}
BENCHES = {
    "dma": {"copy_chunk", "copy_coalesced", "copy_blocked"},
    "attrib": {"setup", "read_chunk", "read_coalesced", "strip_filter_scan", "strip_filter_apply", "strip_filter",
               "lml_tl_strip", "pkfs_from_tl_strip", "launch"},
    "grid": {"noop", "stream3", "stream22", "outwrite12", "carry33", "slope"},
}


@pytest.mark.parametrize("name", PROBES)
def test_cli_on_the_cpu_emits_its_records(name, tmp_path, capsys):
    """``main(["--device", "cpu", ...])`` runs the plain versions at a small
    T, prints one JSON line a record and writes them all to ``--out``; times
    are not measured off the card, and kernel and plain version agree."""
    out = tmp_path / f"{name}.json"
    recs = PROBES[name].main(["--device", "cpu", "--T", "2051", "--dtype", "float64", "--reps", "1", "--out", str(out)])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines == recs == json.loads(out.read_text())
    assert {r["bench"] for r in recs} == BENCHES[name]
    for r in recs:
        assert r["probe"] == name and r["device"] == "cpu" and r["card"] is None and r["dtype"] == "float64"
        assert r.get("ms") is None and r.get("us_per_tile") is None and r.get("device_us") is None
        assert r.get("max_abs_err", 0.0) == 0.0
        if "bytes" in r and r["bytes"] is not None:
            assert r["bound_ms"] == pytest.approx(1e3 * r["bytes"] / common.PEAK_BYTES_PER_S)
    if name == "dma":
        assert {(r["rows"], r.get("K"), r.get("tile")) for r in recs} >= {(27, 64, None), (12, 64, None), (12, None, 2048)}
    if name == "grid":
        assert {r["tile"] for r in recs if "tile" in r} == set(grid.TILES)
    assert set(common.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("name", PROBES)
def test_default_device_is_the_card_and_raises_without_one(name, monkeypatch, tmp_path):
    """``--device`` defaults to cuda: without a card the probe raises and
    writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PROBES[name].main(["--T", "300", "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
