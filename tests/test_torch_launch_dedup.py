"""The port's dedup CLI (``repro_torch.launch.dedup``) against the reference's.

Both run in process on the same flags (the port with ``--device cpu``);
their report lines must agree in every count, the retention clause
included, in host and streaming mode, over either store tier.  The
sharded mode's plain report is held in
``tests/test_torch_sharded_session.py``; here it takes the retention
flags and the sqlite tier.
"""
import re

import pytest

import repro.launch.dedup as ref_dedup
from repro_torch.launch import dedup

# Wall times and rates differ between runs and packages.
_TIMES = re.compile(r"\(\d+ pairs/s\)|[\d.]+s total|in [\d.]+ ms")


def _report(main, argv, capsys):
    main(argv)
    return [_TIMES.sub("", ln) for ln in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("flags", [
    ["--estimate", "--backend", "kernel", "--fused-ingest"],
    ["--batch", "band"],
])
def test_report_counts_match_reference(flags, capsys):
    common = ["--notes", "40", "--dups", "25", "--steps", "2", "--query", "4"]
    got = _report(dedup.main, common + flags + ["--device", "cpu"], capsys)
    ref_flags = [{"kernel": "numpy"}.get(f, f) for f in flags]
    want = _report(ref_dedup.main, common + ref_flags, capsys)
    assert got == want
    assert got[1].startswith("host[2 step(s)]: 65 docs ingested")
    assert got[2].startswith("query[view v1]: 4/4 re-queried notes matched")


def test_retention_and_refine_report_matches_reference(capsys):
    common = ["--notes", "300", "--dups", "200", "--steps", "4", "--estimate",
              "--retain-budget", "small", "--refine-every", "2", "--query", "4"]
    got = _report(dedup.main, common + ["--backend", "kernel", "--use-kernels",
                                        "--device", "cpu"], capsys)
    want = _report(ref_dedup.main, common + ["--backend", "numpy"], capsys)
    assert got == want
    assert "rows retained (" in got[1] and "refine merges)" in got[1]


@pytest.mark.parametrize("mode", [[], ["--byte-ingest"]])
def test_streaming_report_matches_reference(mode, capsys):
    """``--streaming`` in token mode (exact, through the external exact
    verifier) and byte mode (K6 and K1's plain versions, estimate)
    reports the reference's counts, and skips the query demo as the
    reference does."""
    common = ["--notes", "40", "--dups", "25", "--steps", "3", "--streaming",
              "--chunk", "16", "--query", "4"] + mode
    got = _report(dedup.main, common + ["--device", "cpu"], capsys)
    want = _report(ref_dedup.main, common, capsys)
    assert got == want
    assert got[1].startswith("streaming[3 step(s)]: 65 docs ingested")
    assert got[2].startswith("query demo skipped: ")


@pytest.mark.parametrize("mode,head", [
    ([], "host[2 step(s)]: 65 docs ingested"),
    (["--streaming", "--chunk", "16"], "streaming[2 step(s)]: 65 docs"),
])
def test_sqlite_store_report_matches_reference(mode, head, capsys, tmp_path):
    """``--store sqlite`` with a store file each: the host mode's
    cross-step index and query demo go through the disk index, the
    streaming mode verifies off disk (the plain version of K2' here)."""
    common = ["--notes", "40", "--dups", "25", "--steps", "2", "--estimate",
              "--store", "sqlite", "--query", "4"] + mode
    got = _report(dedup.main, common + [
        "--store-path", str(tmp_path / "port.db"), "--backend", "kernel",
        "--device", "cpu"], capsys)
    want = _report(ref_dedup.main, common + [
        "--store-path", str(tmp_path / "ref.db"), "--backend", "numpy"],
        capsys)
    assert got == want
    assert got[1].startswith(head)
    if mode:
        assert got[2].startswith("query demo skipped: ")
    else:
        assert got[2].startswith("query[view v1]: 4/4 re-queried notes")
    assert (tmp_path / "port.db").stat().st_size > 0


@pytest.mark.parametrize("argv,item", [
    (["--sharded", "--retain-budget", "small"], "item 4, second part"),
    (["--sharded", "--refine-every", "2"], "item 4, second part"),
    (["--sharded", "--store", "sqlite", "--retain-budget", "small",
      "--refine-every", "2"], "item 4, second part"),
])
def test_later_slices_exit_with_their_queue_item(argv, item, capsys,
                                                 tmp_path):
    """``--sharded`` with each flag that ``ROADMAP.md`` queue 1 ``item``
    ported, and with all three (a one-rank gloo group), reports the
    reference CLI's counts, the retention clause included; with
    ``--store sqlite`` each CLI keeps its own store file.  (The query
    demo over a sharded session's view is held in
    ``tests/test_torch_sharded_session.py``.)"""
    common = ["--notes", "100", "--dups", "150", "--steps", "2",
              "--band-groups", "5"]
    got = _report(dedup.main, common + argv + [
        "--store-path", str(tmp_path / "port.db"), "--device", "cpu"],
        capsys)
    want = _report(ref_dedup.main, common + argv + [
        "--store-path", str(tmp_path / "ref.db")], capsys)
    assert got == want, item
    assert got[1].startswith(
        "sharded[1 devices x 5 band-group(s) x 2 step(s)]: 250 docs")
    if "--retain-budget" in argv:
        assert "rows retained (" in got[1]
    if "--store" in argv:
        assert (tmp_path / "port.db").stat().st_size > 0
