"""Durable plan artifacts — export and load compiled plans.

A restart of the analysis service used to throw away every compiled plan
and every iteration budget its engine had proved.  This module makes a
:class:`~repro_torch.analysis.plan.CompiledWorkflow` a *durable* object:

* :func:`export_plan` (== ``plan.export(path)``) serializes the plan into a
  single self-contained ``.bmplan`` file: the snapshotted workflow, written
  as its structure plus every function's ``(starts, coeffs)`` arrays
  (:func:`repro_torch.core.convert.workflow_record`), and the engine's
  proven iteration caps (``TorchSweepEngine.proven_caps_rows``).
* :func:`load_plan` rebuilds the plan on a device and pre-arms a fresh
  :class:`~repro_torch.sweep.torch_engine.TorchSweepEngine` with the proven
  caps, so the first warm sweep of a known shape starts at its proven
  budget instead of the overflow ladder's default — bit-identical to a
  fresh ``compile()`` + sweep (counted in the engine's ``warm_hits``).
* :class:`ArtifactStore` is a directory of artifacts keyed by workflow
  fingerprint, written atomically (temp file + fsync + rename + directory
  fsync) so a crash mid-write can never leave a half artifact under the
  final name.  :class:`~repro_torch.analysis.serve.AnalysisService` threads
  it through the serving tier (write on first compile, warm-start on
  ``start()``).

PyTorch has no counterpart to ``jax.export``, so unlike the reference's
artifact this one carries no compiled executables: the engine is ordinary
PyTorch and the CUDA kernels build from source.  The bytes are
deterministic by construction — JSON with sorted keys, raw little-endian
float64, zip entries in a fixed order with a fixed timestamp — so two
exports of one plan are equal.

Integrity and compatibility — every check degrades, never crashes:

* the manifest carries a SHA-256 per member, a content hash over the
  manifest itself, the workflow fingerprint digest and the
  ``level_signature`` digest — any mismatch (bit rot, tampering, a torn
  legacy write) raises a typed :class:`ArtifactError`, which
  :func:`load_plan` turns into a logged re-compile when a fallback workflow
  is available;
* the proven caps are only adopted when the rebuilt plan's level signature
  matches the recorded digest — otherwise the plan still loads and its
  first sweep starts from the default budget (one :class:`ArtifactWarning`);
* an unknown ``format`` (an artifact from a NEWER build, or a fault-injected
  stale stamp) is rejected up front with a typed error, never half-parsed.

Nothing in an artifact is unpickled: the members are JSON and raw floats.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import tempfile
import warnings
import zipfile
from pathlib import Path
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from repro_torch.core.convert import workflow_from_record, workflow_record
from repro_torch.sweep.torch_engine import TorchSweepEngine

if TYPE_CHECKING:
    from .plan import CompiledWorkflow

__all__ = ["ARTIFACT_FORMAT", "ARTIFACT_SUFFIX", "ArtifactError",
           "ArtifactStore", "ArtifactWarning", "build_artifact_bytes",
           "export_plan", "fingerprint_digest", "load_plan"]

#: on-disk format version; a loader only reads its own format (stale or
#: future artifacts are rejected with a typed error and compiled cold)
ARTIFACT_FORMAT = 1
ARTIFACT_SUFFIX = ".bmplan"

_MANIFEST_MEMBER = "manifest.json"
_STRUCTURE_MEMBER = "workflow.json"
_ARRAYS_MEMBER = "workflow.f64"
_ZIP_TIME = (1980, 1, 1, 0, 0, 0)


class ArtifactError(RuntimeError):
    """A plan artifact failed verification: corrupt bytes, digest or
    fingerprint mismatch, unsupported format, or an unreadable container.

    :func:`load_plan` converts this into a logged re-compile when the caller
    provides a fallback ``workflow``; the serving tier counts it in
    ``ServiceStats.artifact_errors`` and cold-compiles instead."""


class ArtifactWarning(UserWarning):
    """A plan artifact degraded gracefully (caps skipped, fallback
    re-compile, failed persist) — the typed warning category every artifact
    code path uses, so tests and operators can filter on it."""


# ---------------------------------------------------------------------------
# canonical digests (pickle-independent, stable across processes)
# ---------------------------------------------------------------------------

def _digest_update(h: Any, obj: Any) -> None:
    if isinstance(obj, (tuple, list)):
        h.update(b"(%d:" % len(obj))
        for x in obj:
            _digest_update(h, x)
        h.update(b")")
    elif isinstance(obj, bytes):
        h.update(b"b%d:" % len(obj))
        h.update(obj)
    elif isinstance(obj, str):
        e = obj.encode()
        h.update(b"s%d:" % len(e))
        h.update(e)
    elif isinstance(obj, bool):
        h.update(b"T" if obj else b"F")
    elif isinstance(obj, int):
        h.update(b"i%d;" % obj)
    elif isinstance(obj, float):
        h.update(b"f")
        h.update(struct.pack("<d", obj))
    elif obj is None:
        h.update(b"N")
    else:
        raise TypeError(
            f"cannot canonically digest node of type {type(obj).__name__}")


def _digest_obj(obj: Any) -> str:
    """Canonical SHA-256 over a nested tuple/bytes/scalar structure — the
    digest of a workflow fingerprint or level signature."""
    h = hashlib.sha256()
    _digest_update(h, obj)
    return h.hexdigest()


def fingerprint_digest(workflow: Any) -> str:
    """SHA-256 hex digest of
    :func:`~repro_torch.analysis.serve.workflow_fingerprint` — the artifact
    filename stem and the load-time identity check."""
    from .serve import workflow_fingerprint

    wf = getattr(workflow, "workflow", workflow)  # accept plans too
    return _digest_obj(workflow_fingerprint(wf))


# ---------------------------------------------------------------------------
# build / write
# ---------------------------------------------------------------------------

def _json_bytes(obj: Any, **kw: Any) -> bytes:
    return json.dumps(obj, sort_keys=True, **kw).encode()


def build_artifact_bytes(plan: "CompiledWorkflow", *,
                         _format: int = ARTIFACT_FORMAT) -> bytes:
    """The complete artifact container as bytes (callers write atomically).

    ``_format`` exists for fault injection only
    (:attr:`~repro_torch.analysis.faults.FaultPlan.stale_artifact_version`).
    """
    engine = plan._torch_engine
    caps = engine.proven_caps_rows() if engine is not None else []
    structure, flat = workflow_record(plan.workflow)
    members = {
        _STRUCTURE_MEMBER: _json_bytes(structure),
        _ARRAYS_MEMBER: np.ascontiguousarray(flat, "<f8").tobytes(),
    }
    core = {
        "format": int(_format),
        "torch_version": torch.__version__,
        "fingerprint": fingerprint_digest(plan),
        "level_signature": _digest_obj(plan.level_signature),
        "proven_caps": [list(row) for row in caps],
        "members": {name: hashlib.sha256(data).hexdigest()
                    for name, data in members.items()},
    }
    core["content_hash"] = hashlib.sha256(_json_bytes(core)).hexdigest()
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        payloads = [(_MANIFEST_MEMBER, _json_bytes(core, indent=1))]
        payloads += sorted(members.items())
        for name, data in payloads:
            # fixed timestamp: identical plans produce identical artifacts
            info = zipfile.ZipInfo(name, date_time=_ZIP_TIME)
            info.compress_type = zipfile.ZIP_DEFLATED
            zf.writestr(info, data)
    return buf.getvalue()


def _atomic_write(path: Path, data: bytes) -> None:
    """temp file in the target directory + fsync + rename + dir fsync: the
    final name either holds the complete artifact or does not exist."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                               prefix=path.name + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    dfd = os.open(str(path.parent), os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def export_plan(plan: "CompiledWorkflow", path: Any) -> Path:
    """Serialize ``plan`` into a self-contained artifact at ``path``
    (atomic write); the method spelling is ``plan.export(path)``."""
    path = Path(path)
    _atomic_write(path, build_artifact_bytes(plan))
    return path


# ---------------------------------------------------------------------------
# verify / load
# ---------------------------------------------------------------------------

def _load_verified(path: Path):
    """-> (workflow, manifest).

    Raises :class:`ArtifactError` for anything that makes the artifact
    unusable (container, manifest, format, workflow members).
    """
    try:
        zf = zipfile.ZipFile(path)
    except (OSError, zipfile.BadZipFile) as e:
        raise ArtifactError(
            f"artifact {path} is not a readable container: {e}") from None
    with zf:
        try:
            manifest = json.loads(zf.read(_MANIFEST_MEMBER).decode())
        except Exception as e:  # noqa: BLE001 — any failure means corrupt
            raise ArtifactError(
                f"artifact {path}: manifest unreadable: {e}") from None
        if not isinstance(manifest, dict):
            raise ArtifactError(f"artifact {path}: manifest is not an object")
        fmt = manifest.get("format")
        if fmt != ARTIFACT_FORMAT:
            raise ArtifactError(
                f"artifact {path}: unsupported format {fmt!r} (this build "
                f"reads format {ARTIFACT_FORMAT}); re-export the plan")
        declared = manifest.get("content_hash")
        core = {k: v for k, v in manifest.items() if k != "content_hash"}
        if hashlib.sha256(_json_bytes(core)).hexdigest() != declared:
            raise ArtifactError(
                f"artifact {path}: manifest content hash mismatch "
                "(tampered or torn)")
        digests = manifest.get("members") or {}
        blobs = {}
        for name in (_STRUCTURE_MEMBER, _ARRAYS_MEMBER):
            try:
                blobs[name] = zf.read(name)
            except Exception as e:  # noqa: BLE001
                raise ArtifactError(
                    f"artifact {path}: member {name} unreadable: {e}") from None
            if hashlib.sha256(blobs[name]).hexdigest() != digests.get(name):
                raise ArtifactError(
                    f"artifact {path}: member {name} digest mismatch "
                    "(corrupt bytes)")
    try:
        structure = json.loads(blobs[_STRUCTURE_MEMBER].decode())
        flat = np.frombuffer(blobs[_ARRAYS_MEMBER], dtype="<f8")
        workflow = workflow_from_record(structure, flat)
    except Exception as e:  # noqa: BLE001
        raise ArtifactError(
            f"artifact {path}: workflow members do not rebuild a "
            f"workflow: {e}") from None
    return workflow, manifest


def load_plan(path: Any, *, workflow: Any = None, strict: bool = False,
              device: Any = None) -> "CompiledWorkflow":
    """Rehydrate a :class:`CompiledWorkflow` on ``device`` (default: the
    CUDA card) from a plan artifact.

    On success the plan carries a fused engine pre-armed with the
    artifact's proven iteration caps: warm sweeps of the recorded shapes
    start at their proven budget and are bit-identical to a fresh
    ``compile()``.

    Verification failure (corrupt bytes, digest/fingerprint mismatch,
    unsupported format) degrades: with a fallback ``workflow`` (a
    :class:`~repro_torch.core.workflow.Workflow` or an existing plan) the
    function warns (:class:`ArtifactWarning`) and returns a fresh compile.
    With no fallback, or ``strict=True``, the typed :class:`ArtifactError`
    propagates.

    A level-signature mismatch is softer still: the plan loads and its
    engine starts from the default budget, with one warning.
    """
    from .plan import CompiledWorkflow, compile_workflow
    from .serve import workflow_fingerprint

    try:
        wf, manifest = _load_verified(Path(path))
        if _digest_obj(workflow_fingerprint(wf)) != manifest.get("fingerprint"):
            raise ArtifactError(
                f"artifact {path}: workflow fingerprint mismatch (the "
                "stored workflow is not the one the manifest promises)")
        plan = compile_workflow(wf, device=device)
    except ArtifactError as e:
        if strict or workflow is None:
            raise
        warnings.warn(
            f"plan artifact failed verification ({e}); degrading to a "
            "fresh compile", ArtifactWarning, stacklevel=2)
        if isinstance(workflow, CompiledWorkflow):
            return workflow
        return compile_workflow(workflow, device=device)

    caps = manifest.get("proven_caps") or []
    if _digest_obj(plan.level_signature) != manifest.get("level_signature"):
        warnings.warn(
            f"plan artifact {path}: proven caps skipped (level signature "
            "mismatch); the plan loaded and its first sweep starts from the "
            "default iteration budget", ArtifactWarning, stacklevel=2)
    elif caps:
        engine = TorchSweepEngine(plan)
        engine.adopt_proven_caps(caps)
        plan._torch_engine = engine
    return plan


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

class ArtifactStore:
    """A directory of plan artifacts, one per workflow fingerprint.

    ``put`` writes atomically; ``scan`` lists what a warm start should load;
    ``journal_dir`` is where the service parks per-track delta journals.
    ``faults`` (set by the service from its :class:`FaultPlan`) lets the
    chaos suite corrupt or version-skew the Nth write deterministically.
    """

    def __init__(self, root: Any, *, faults: Any = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.faults = faults
        #: 1-based census of artifact writes (fault hooks key on it)
        self.writes = 0

    def path_for(self, plan_or_workflow: Any) -> Path:
        return self.root / (fingerprint_digest(plan_or_workflow)[:16]
                            + ARTIFACT_SUFFIX)

    def put(self, plan: "CompiledWorkflow") -> Path:
        """Atomically (re-)write ``plan``'s artifact; returns its path."""
        self.writes += 1
        fmt = ARTIFACT_FORMAT
        if self.faults is not None:
            fmt = self.faults.artifact_format(self.writes, fmt)
        data = build_artifact_bytes(plan, _format=fmt)
        if self.faults is not None:
            data = self.faults.mutate_artifact(self.writes, data)
        path = self.path_for(plan)
        _atomic_write(path, data)
        return path

    def scan(self) -> list[Path]:
        """Every artifact path in the store (sorted, deterministic)."""
        return sorted(self.root.glob("*" + ARTIFACT_SUFFIX))

    def journal_dir(self) -> Path:
        d = self.root / "journals"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def __repr__(self) -> str:
        return (f"ArtifactStore({str(self.root)!r}, "
                f"artifacts={len(self.scan())})")
