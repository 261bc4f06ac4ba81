"""Append-only, checksummed delta journal — crash-recoverable online state.

:class:`~repro_torch.analysis.serve.OnlineReanalysis` accumulates live measured
state one monitoring delta at a time; a process crash used to lose all of
it.  The journal makes every acknowledged ingest durable:

* records are length-prefixed and CRC32-checksummed
  (``<u32 length><u32 crc32><pickle payload>`` after a ``BMJL\\x01`` file
  header), appended with flush + fsync BEFORE the delta is applied to the
  pack — write-ahead, so an acknowledged ingest survives SIGKILL and an
  unacknowledged one was never applied;
* a crash mid-append leaves a *torn tail* (truncated record, bad CRC, or
  even a torn file header): :func:`recover_journal` detects it, truncates
  the file back to the last intact record with a typed
  :class:`JournalWarning`, and returns the intact records for replay;
* record 1 is a *genesis* record (written by the serving tier) embedding
  the workflow and scenario list, so ``svc.recover(track_id)`` can rebuild
  the session from the journal alone and replay every delta through the
  same ``ScenarioPack.override`` path the live ingests took —
  bit-identical state, proven by the SIGKILL chaos test.

The CRC layer detects torn writes and bit rot, not adversaries; journals
are pickle-backed and belong in the same trust domain as the artifact
store.

Payloads unpickle through :class:`_PortUnpickler`, which imports nothing
outside this package, numpy, ``builtins`` and ``collections``. A journal
written by the JAX reference (same framing) names the reference's classes:
those whose pickled state fits this package's twin of the same name are
mapped to the twin (:data:`MAPPED_CLASSES`); every other class — the rest
of ``repro``, ``jax`` and anything else — is refused with
:class:`JournalError` naming it, so reading a journal never loads the
reference or JAX.
"""

from __future__ import annotations

import io
import os
import pickle
import struct
import warnings
import zlib
from pathlib import Path
from typing import Any

__all__ = ["Journal", "JournalError", "JournalWarning", "read_journal",
           "recover_journal"]

_FILE_MAGIC = b"BMJL\x01"
_REC_HEADER = struct.Struct("<II")  # (payload length, crc32(payload))
#: sanity bound — a length field beyond this means a corrupt header, not a
#: real record, so scanning stops there instead of allocating garbage
_MAX_RECORD = 1 << 26

#: reference module -> class names whose pickled state (``__dict__`` or
#: ``__slots__``) has exactly the fields of the twin at the same path
#: under ``repro_torch``
MAPPED_CLASSES: dict[str, frozenset[str]] = {
    "repro.core.ppoly": frozenset({"PPoly"}),
    "repro.core.process": frozenset({"Process", "DataDep", "ResourceDep"}),
    "repro.core.workflow": frozenset({"Workflow", "_Edge"}),
    "repro.sweep.batch": frozenset({"Scenario"}),
    "repro.analysis.scenarios": frozenset({
        "ScenarioSpec", "Dist", "LogNormal", "Uniform", "Triangular",
        "Discrete", "DistRamp"}),
}
_ALLOWED_ROOTS = ("repro_torch", "numpy", "builtins", "collections")


class _PortUnpickler(pickle.Unpickler):
    """Resolves a payload's classes without importing ``repro`` or ``jax``:
    reference classes in :data:`MAPPED_CLASSES` become their
    ``repro_torch`` twins; any other module outside this package, numpy,
    ``builtins`` and ``collections`` raises :class:`JournalError`."""

    def find_class(self, module: str, name: str) -> Any:
        if name in MAPPED_CLASSES.get(module, ()):
            module = "repro_torch" + module[len("repro"):]
        elif module.split(".", 1)[0] not in _ALLOWED_ROOTS:
            raise JournalError(
                f"journal record holds {module}.{name}, which has no "
                "repro_torch twin; refusing to import it")
        return super().find_class(module, name)


def _loads(payload: bytes) -> Any:
    return _PortUnpickler(io.BytesIO(payload)).load()


class JournalError(RuntimeError):
    """The journal file is unusable as-is: missing, foreign bytes where the
    header should be, or opened for append while carrying a torn tail
    (run :func:`recover_journal` first)."""


class JournalWarning(UserWarning):
    """Recovery degraded gracefully — typically a torn tail truncated back
    to the last intact record."""


def _scan(path: Path, *, parse: bool = True):
    """-> (records, good_size_bytes, torn_reason_or_None).

    Reads records sequentially, stopping at the first torn/corrupt one;
    ``good_size_bytes`` is the offset a recovery truncates back to.
    """
    path = Path(path)
    if not path.exists():
        raise JournalError(f"no journal at {path}")
    raw = path.read_bytes()
    if len(raw) < len(_FILE_MAGIC):
        if _FILE_MAGIC.startswith(raw):
            # killed between create and header fsync: everything is torn
            return [], 0, "torn file header"
        raise JournalError(f"{path}: not a journal (bad header)")
    if not raw.startswith(_FILE_MAGIC):
        raise JournalError(f"{path}: not a journal (bad header)")
    off = len(_FILE_MAGIC)
    records: list[Any] = []
    torn: str | None = None
    while off < len(raw):
        if off + _REC_HEADER.size > len(raw):
            torn = "torn record header"
            break
        length, crc = _REC_HEADER.unpack_from(raw, off)
        if length > _MAX_RECORD:
            torn = f"implausible record length {length} (corrupt header)"
            break
        lo = off + _REC_HEADER.size
        hi = lo + length
        if hi > len(raw):
            torn = "torn record payload"
            break
        payload = raw[lo:hi]
        if zlib.crc32(payload) != crc:
            torn = "record checksum mismatch"
            break
        if parse:
            try:
                records.append(_loads(payload))
            except JournalError:
                raise  # a refused class is not a torn tail: keep the file
            except Exception as e:  # noqa: BLE001 — checksummed but stale
                torn = f"record does not unpickle ({e})"
                break
        else:
            records.append(None)
        off = hi
    return records, off, torn


def read_journal(path: Any) -> tuple[list[Any], str | None]:
    """Read every intact record WITHOUT modifying the file.

    Returns ``(records, torn_reason)`` — ``torn_reason`` is ``None`` for a
    clean journal, else a description of the torn tail left in place.
    """
    records, _good, torn = _scan(Path(path))
    return records, torn


def recover_journal(path: Any) -> tuple[list[Any], str | None]:
    """Read every intact record AND truncate any torn tail in place.

    The truncation is fsynced, so after recovery the journal is clean and
    appendable.  Emits one :class:`JournalWarning` naming what was cut.
    """
    path = Path(path)
    records, good, torn = _scan(path)
    if torn is not None:
        size = path.stat().st_size
        warnings.warn(
            f"journal {path}: {torn} at byte {good}; truncating "
            f"{size - good} torn byte(s) and keeping {len(records)} intact "
            "record(s)", JournalWarning, stacklevel=2)
        with open(path, "r+b") as f:
            f.truncate(good)
            f.flush()
            os.fsync(f.fileno())
    return records, torn


class Journal:
    """Append-only record log with per-record checksums and fsync'd writes.

    Opening an existing journal validates it end-to-end (a torn tail raises
    :class:`JournalError` — recover first); opening a new path writes the
    file header.  ``faults`` hooks the Nth append to write only a torn
    prefix and raise, simulating a writer killed mid-write
    (:attr:`~repro_torch.analysis.faults.FaultPlan.torn_journal_write`).
    """

    def __init__(self, path: Any, *, faults: Any = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._faults = faults
        fresh = not self.path.exists() or self.path.stat().st_size == 0
        if not fresh:
            recs, _good, torn = _scan(self.path, parse=False)
            if torn is not None:
                raise JournalError(
                    f"journal {self.path} has a torn tail ({torn}); run "
                    "recover_journal() before appending")
            self.n_records = len(recs)
        else:
            self.n_records = 0
        self._f = open(self.path, "ab")
        if fresh:
            self._f.write(_FILE_MAGIC)
            self._f.flush()
            os.fsync(self._f.fileno())

    def append(self, obj: Any) -> int:
        """Durably append one record; returns its 1-based index.

        The record is flushed and fsynced before this returns — an
        acknowledged append survives SIGKILL.
        """
        if self._f is None or self._f.closed:
            raise JournalError(f"journal {self.path} is closed")
        payload = pickle.dumps(obj, protocol=4)
        record = _REC_HEADER.pack(len(payload), zlib.crc32(payload)) + payload
        index = self.n_records + 1
        torn = self._faults is not None and self._faults.tear_journal(index)
        if torn:
            # fault injection: persist only a prefix, then die like a
            # writer killed mid-write — recovery must truncate this tail
            record = record[:_REC_HEADER.size + max(1, len(payload) // 2)]
        self._f.write(record)
        self._f.flush()
        os.fsync(self._f.fileno())
        if torn:
            self.close()
            from .faults import FaultInjected

            raise FaultInjected(
                f"fault injection: torn journal write (record {index}); the "
                "writer is considered crashed — recover_journal() truncates "
                "the torn tail")
        self.n_records = index
        return index

    def close(self) -> None:
        if self._f is not None and not self._f.closed:
            self._f.close()

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def __repr__(self) -> str:
        state = "closed" if (self._f is None or self._f.closed) else "open"
        return (f"Journal({str(self.path)!r}, records={self.n_records}, "
                f"{state})")
