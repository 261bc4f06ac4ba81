"""Crash-recoverable online re-analysis in the port, on the CPU: the twin
of ``tests/test_durability.py``.

Contracts under test:

* **journal mechanics**: append/read round trip (and the same bytes as
  ``repro``'s journal: either package reads the other's file); a torn tail
  is detected, reported once via ``JournalWarning`` and truncated back to
  the last intact record, after which the journal is appendable again;
  foreign bytes raise the typed ``JournalError``,
* **write-ahead recovery is bit-identical**: ``svc.recover(track_id)``
  replays journaled deltas through ``ScenarioPack.override`` and the
  rebuilt pack's ``state_digest()`` matches the live session's — in-process,
  after an injected torn write, and after a real ``SIGKILL`` of a serving
  process mid-ingest (a child that imports neither JAX nor ``repro``),
* **quarantine**: malformed monitoring deltas are dropped with one
  ``MalformedDeltaWarning`` while well-formed neighbors still apply,
* **stats**: an empty latency window yields ``None`` percentiles, and a
  warm-started service counts warm plans and serves from proven caps.

Every file lives under ``tmp_path``; every service closes in a ``with``
block; every service runs on ``device="cpu"``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest

from repro.analysis.journal import Journal as RefJournal
from repro.analysis.journal import read_journal as ref_read_journal
from repro_torch.analysis import (AnalysisService, FaultInjected, FaultPlan,
                                  Journal, JournalError, JournalWarning,
                                  MalformedDeltaWarning, ServiceStats,
                                  recover_journal)
from repro_torch.analysis.journal import read_journal
from repro_torch.configs.paper_workflow import build_workflow, sweep_scenarios
from repro_torch.core.ppoly import PPoly

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 120  # bound every result() so a wedged worker fails the test, not CI
CPU = "cpu"


# ------------------------------------------------------- journal mechanics --
def test_journal_append_read_roundtrip(tmp_path):
    path = tmp_path / "t.journal"
    recs = [{"kind": "genesis", "n": 0},
            {"kind": "delta", "deltas": {"dl1.link": np.float64(0.25)}},
            {"kind": "delta", "deltas": {"task1.cpu": 2.0}}]
    with Journal(path) as j:
        assert [j.append(r) for r in recs] == [1, 2, 3]
        assert j.n_records == 3
    got, torn = read_journal(path)
    assert torn is None
    assert got == recs
    with Journal(path) as j2:
        assert j2.n_records == 3
        assert j2.append({"kind": "delta", "deltas": {}}) == 4
    # the same framing as the reference: each package reads the other's
    ref_path = tmp_path / "ref.journal"
    with RefJournal(ref_path) as jr:
        for r in recs:
            jr.append(r)
    assert read_journal(ref_path) == (recs, None)
    assert ref_read_journal(path) == (recs + [{"kind": "delta",
                                               "deltas": {}}], None)
    assert ref_path.read_bytes() == path.read_bytes()[:ref_path.stat().st_size]


def test_journal_torn_tail_truncated_then_appendable(tmp_path):
    path = tmp_path / "t.journal"
    with Journal(path) as j:
        for i in range(3):
            j.append({"i": i})
    size_clean = path.stat().st_size
    with open(path, "ab") as f:          # a writer died mid-append
        f.write(b"\x40\x00\x00\x00\x99\x99\x99\x99partial")
    recs, torn = read_journal(path)
    assert [r["i"] for r in recs] == [0, 1, 2] and torn is not None
    assert path.stat().st_size > size_clean
    with pytest.raises(JournalError, match="torn tail"):
        Journal(path)
    with pytest.warns(JournalWarning, match="truncating"):
        recs2, torn2 = recover_journal(path)
    assert [r["i"] for r in recs2] == [0, 1, 2] and torn2 is not None
    assert path.stat().st_size == size_clean
    with Journal(path) as j2:            # clean again: appendable
        assert j2.append({"i": 3}) == 4
    assert read_journal(path) == ([{"i": i} for i in range(4)], None)


def test_journal_checksum_mismatch_cuts_back(tmp_path):
    path = tmp_path / "t.journal"
    with Journal(path) as j:
        off_last = None
        for i in range(3):
            off_last = path.stat().st_size
            j.append({"i": i})
    raw = bytearray(path.read_bytes())
    raw[off_last + 8] ^= 0xFF            # flip one payload byte of record 3
    path.write_bytes(raw)
    with pytest.warns(JournalWarning, match="checksum"):
        recs, torn = recover_journal(path)
    assert [r["i"] for r in recs] == [0, 1] and "checksum" in torn
    assert path.stat().st_size == off_last


def test_journal_rejects_foreign_and_missing_files(tmp_path):
    foreign = tmp_path / "foreign.journal"
    foreign.write_bytes(b"definitely not a journal file")
    with pytest.raises(JournalError, match="bad header"):
        read_journal(foreign)
    with pytest.raises(JournalError, match="no journal"):
        read_journal(tmp_path / "absent.journal")
    torn_hdr = tmp_path / "torn.journal"
    torn_hdr.write_bytes(b"BMJ")
    with pytest.warns(JournalWarning):
        recs, torn = recover_journal(torn_hdr)
    assert recs == [] and torn is not None
    with Journal(torn_hdr) as j:
        assert j.append({"ok": 1}) == 1


# ------------------------------------------------- recovery bit-identity ---
def _service(tmp_path, **kw):
    return AnalysisService(build_workflow(0.5), store=tmp_path / "store",
                           device=CPU, **kw)


def test_recover_in_process_bit_identical(tmp_path):
    with _service(tmp_path) as svc:
        live = svc.track(sweep_scenarios([0.5]), track_id="run1")
        live.ingest({"dl1.link": np.float64(0.5)}, timeout=T)
        rep_live = live.ingest({"dl1.link": np.float64(0.25)}, timeout=T)
        dig_live = live.pack.state_digest()
        live.close()
    with _service(tmp_path) as svc2:
        rec = svc2.recover("run1")
        assert rec.pack.state_digest() == dig_live
        assert rec.updates == 2
        rep_rec = rec.refresh()
        np.testing.assert_array_equal(rep_live.makespans, rep_rec.makespans)
        snap = svc2.snapshot()
        assert snap["recovered_tracks"] == 1
        assert snap["replayed_deltas"] == 2
        rec.ingest({"dl1.link": np.float64(0.2)}, timeout=T)
        dig2 = rec.pack.state_digest()
        rec.close()
    with _service(tmp_path) as svc3:
        rec3 = svc3.recover("run1")
        assert rec3.pack.state_digest() == dig2
        rec3.close()


def test_faultplan_torn_write_degrades_then_recovers(tmp_path):
    faults = FaultPlan(torn_journal_write=3)  # genesis=1, ok delta=2, torn=3
    with _service(tmp_path, faults=faults) as svc:
        live = svc.track(sweep_scenarios([0.5]), track_id="torn")
        live.ingest({"dl1.link": np.float64(0.5)}, timeout=T)
        dig_before = live.pack.state_digest()
        with pytest.raises(FaultInjected, match="torn journal write"):
            live.ingest({"dl1.link": np.float64(0.25)}, timeout=T)
        assert live.pack.state_digest() == dig_before
    with _service(tmp_path) as svc2:
        with pytest.warns(JournalWarning, match="truncating"):
            rec = svc2.recover("torn")
        assert rec.updates == 1
        assert rec.pack.state_digest() == dig_before
        rec.close()


def test_recover_requires_intact_genesis(tmp_path):
    with _service(tmp_path) as svc:
        path = svc._journal_path("empty")
        Journal(path).close()
        with pytest.raises(JournalError, match="genesis"):
            svc.recover("empty")


def test_track_id_validation(tmp_path):
    with _service(tmp_path) as svc:
        for bad in ("", ".", "..", "a/b", "a\\b", "a\0b"):
            with pytest.raises(ValueError, match="track_id"):
                svc.track(sweep_scenarios([0.5]), track_id=bad)
    with AnalysisService(build_workflow(0.5), device=CPU) as nostore:
        with pytest.raises(ValueError, match="store"):
            nostore.track(sweep_scenarios([0.5]), track_id="x")


# ------------------------------------------------------- SIGKILL chaos -----
_CHAOS_CHILD = r"""
import os, sys
import numpy as np
from repro_torch.analysis import AnalysisService
from repro_torch.configs.paper_workflow import build_workflow, sweep_scenarios

store, side, mods = sys.argv[1], sys.argv[2], sys.argv[3]
svc = AnalysisService(build_workflow(0.5), store=store, device="cpu")
live = svc.track(sweep_scenarios([0.5]), track_id="chaos")
for k in range(500):
    live.ingest({"dl1.link": np.float64(0.4 + 0.001 * k)})
    if k == 0:
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        with open(mods, "w") as f:
            f.write(repr(bad))
    tmp = side + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{k} {live.pack.state_digest()}\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, side)
print("CHILD-FINISHED-UNKILLED")  # the parent should never let us get here
"""


def test_sigkill_mid_ingest_recovers_bit_identically(tmp_path):
    """SIGKILL a serving process mid-ingest; recover its session from the
    journal; the rebuilt state matches the last state the child
    acknowledged and an independent replay of the journal."""
    store = tmp_path / "store"
    side = tmp_path / "acked.txt"
    mods = tmp_path / "modules.txt"
    script = tmp_path / "chaos_child.py"
    script.write_text(_CHAOS_CHILD)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, str(script), str(store), str(side), str(mods)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 300
        while time.time() < deadline:
            if side.exists() and int(side.read_text().split()[0]) >= 3:
                break
            if proc.poll() is not None:
                out, err = proc.communicate()
                pytest.fail(f"chaos child died early:\n{out}\n{err}")
            time.sleep(0.02)
        else:
            pytest.fail("chaos child never acknowledged 4 ingests")
    finally:
        proc.kill()  # SIGKILL: no atexit, no flush, no graceful anything
        out, _err = proc.communicate(timeout=30)
    assert "CHILD-FINISHED-UNKILLED" not in (out or "")
    assert mods.read_text() == "[]", "the serving child loaded JAX or repro"

    k_acked, dig_acked = side.read_text().split()
    k_acked = int(k_acked)

    with AnalysisService(store=store, device=CPU) as svc:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rec = svc.recover("chaos")
        assert all(issubclass(w.category, JournalWarning) for w in caught)
        assert k_acked + 1 <= rec.updates <= k_acked + 2

        journal_path = svc._journal_path("chaos")
        records, torn = read_journal(journal_path)
        assert torn is None, "recover() left a torn tail behind"
        deltas = [r["deltas"] for r in records[1:]]
        plan = build_workflow(0.5).compile(device=CPU)
        pack = plan.prepare(sweep_scenarios([0.5]))
        for d in deltas[:k_acked + 1]:
            pack = pack.override(d)
        assert pack.state_digest() == dig_acked
        for d in deltas[k_acked + 1:]:
            pack = pack.override(d)
        assert rec.pack.state_digest() == pack.state_digest()

        rep = rec.refresh()
        ref = plan.sweep(pack, backend="torch")
        np.testing.assert_array_equal(rep.makespans, ref.makespans)
        rec.close()


# ------------------------------------------------------- delta quarantine --
def test_quarantine_drops_malformed_keeps_good(tmp_path):
    with _service(tmp_path) as svc:
        live = svc.track(sweep_scenarios([0.5]), track_id="q")
        base = live.refresh()
        with pytest.warns(MalformedDeltaWarning, match="quarantined 2"):
            rep = live.ingest({
                "dl1.link": np.float64(0.5),           # well-formed: applies
                "task1.cpu": np.float64("nan"),        # NaN scalar
                "dl1.remote": PPoly.linear(100.0, -1.0),  # runs backwards
            }, timeout=T)
        assert live.quarantined == 2
        assert rep.makespans[0] > base.makespans[0]
        snap = svc.snapshot()
        assert snap["quarantined"] == 2
        reasons = dict(snap["top_quarantine_reasons"])
        assert reasons == {"task1.cpu: non-finite scalar": 1,
                           "dl1.remote: non-monotone measured progress": 1}
        dig = live.pack.state_digest()
        live.close()
    with _service(tmp_path) as svc2:
        rec = svc2.recover("q")
        assert rec.updates == 1 and rec.pack.state_digest() == dig
        rec.close()


def test_quarantine_nonfinite_ppoly_coefficients():
    from repro_torch.analysis.serve import OnlineReanalysis

    plan = build_workflow(0.5).compile(device=CPU)
    live = OnlineReanalysis(plan, sweep_scenarios([0.5]))
    bad = PPoly(np.array([0.0]), [[np.inf]])
    with pytest.warns(MalformedDeltaWarning, match="non-finite PPoly"):
        live.ingest({"dl1.link": bad})
    assert live.quarantined == 1
    with pytest.raises(Exception, match="nosuch"):
        live.ingest({"nosuch.cpu": 2.0})


# ------------------------------------------------------- stats satellites --
def test_empty_window_latency_quantiles_are_none():
    stats = ServiceStats()
    assert stats.latency_quantiles() == (None, None)
    assert stats.latency_quantiles((0.1, 0.5, 0.9)) == (None, None, None)
    snap = stats.snapshot()
    assert snap["latency_p50_s"] is None and snap["latency_p99_s"] is None


def test_warm_service_counts_warm_plans_and_serves_from_proven_caps(tmp_path):
    store = tmp_path / "store"
    scs = sweep_scenarios([0.3, 0.6])
    with AnalysisService(build_workflow(0.5), store=store, device=CPU) as cold:
        rep_cold = cold.query(scs, timeout=T)
        cold_snap = cold.snapshot()
    assert cold_snap["artifacts_written"] >= 1
    assert cold_snap["warm_plans"] == 0 and cold_snap["cold_traces"] >= 1
    with AnalysisService(build_workflow(0.5), store=store, device=CPU) as warm:
        snap0 = warm.snapshot()
        assert snap0["warm_plans"] == 1
        assert snap0["plan_hits"] >= 1  # constructor compile hit the cache
        rep_warm = warm.query(scs, timeout=T)
        snap = warm.snapshot()
    assert snap["cold_traces"] == 0, "warm service solved from a cold cap"
    assert snap["warm_hits"] >= 1
    np.testing.assert_array_equal(rep_cold.makespans, rep_warm.makespans)
    for n in rep_cold.order:
        np.testing.assert_array_equal(rep_cold.finish[n], rep_warm.finish[n])
    np.testing.assert_array_equal(rep_cold.share_seconds, rep_warm.share_seconds)
