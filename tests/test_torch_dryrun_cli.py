"""The dry run's command line (``python -m repro_torch.launch.dryrun``)
over every full-width cell of one shape, on the CPU: ``decode_32k`` for
the ten configs on both production meshes, 20 records, each ``ok``,
none failed; a second call reads the records back."""
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402


def test_cli_writes_a_record_for_every_decode_cell(tmp_path, capsys):
    assert DR.main(["--shape", "decode_32k", "--out", str(tmp_path)]) == 0
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert len(recs) == 2 * len(TC.ARCHS) == 20
    assert {r["arch"] for r in recs} == set(TC.ARCHS)
    for r in recs:
        assert r["status"] == "ok" and r["ok"], r.get("error")
        assert r["shape"] == "decode_32k" and r["kind"] == "decode"
        assert r["flops"] > 0 and r["bytes_accessed"] > 0
        assert r["placed"]["cache_bytes"] > 0
        assert r["argument_size_in_bytes"] < r["placed_bytes"]
        sent = sum(v["bytes"] for v in r["collectives"].values())
        assert (sent > 0) == (TC.get_config(r["arch"]).moe is not None)
    out = capsys.readouterr().out
    assert "dry-run complete: ok=20 skip=0 fail=0" in out
    assert DR.main(["--shape", "decode_32k", "--out", str(tmp_path),
                    "--arch", "rwkv6_7b", "--mesh", "single"]) == 0
    assert "ok=1 skip=0" in capsys.readouterr().out
