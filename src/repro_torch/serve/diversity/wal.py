"""Write-ahead log for the diversity stream.

Reference: ``repro/serve/diversity/wal.py`` (numpy and the standard
library only; the port keeps its own copy). The file format is the
reference's byte for byte, so a log written by either package replays in
the other.

The paper's §3 composability makes the stream itself the unit of
durability: a ``StreamState`` is a pure fold over the batch sequence, so
"what the service knows" is fully determined by (a serialized state, the
tail of batches after it). This module is the tail: an append-only
binary log of submitted batches, written *before* a batch is enqueued
for ingestion, so a crash between submit and ingest loses nothing the
caller was told was accepted.

Record framing (little-endian), after a one-line magic header:

    u64 seq | u32 n | u32 d | u32 gamma | u32 crc || f32[n,d] || i32[n,gamma]

``crc`` is ``zlib.crc32`` over the header prefix + payload, so replay
detects a torn tail (a crash mid-append) and stops cleanly at the last
whole record instead of feeding garbage to the scan — the torn record's
batch was never acknowledged as durable anyway (``append`` raises on
failure). ``gamma == 0`` encodes "no cats passed" (replay hands the
scan ``None``, exactly like the live call).

``seq`` is the runtime's submission ordinal: strictly increasing within
one log, possibly with gaps (a batch whose append failed burns its seq).
Replay yields records in file order = submission order, the order the
single ingest worker applies them — so checkpoint + replayed tail is
bit-identical to the uninterrupted stream. ``compact(upto_seq)``
atomically rewrites the log keeping only records after a checkpoint.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import struct
import threading
import zlib
from typing import Iterator, Optional

import numpy as np

from ... import obs

_MAGIC = b"DMMCWAL1\n"
_HDR = struct.Struct("<QIIII")  # seq, n, d, gamma, crc

_log = logging.getLogger("repro_torch.serve.diversity.wal")


@dataclasses.dataclass(frozen=True)
class WalRecord:
    seq: int
    points: np.ndarray  # f32[n, d]
    cats: Optional[np.ndarray]  # i32[n, gamma] or None (gamma == 0)


class WalError(RuntimeError):
    """A WAL append failed: the batch is NOT durable (and was not
    enqueued). The submitter must retry or accept the loss."""


def _frame(seq: int, points: np.ndarray,
           cats: Optional[np.ndarray]) -> "list[memoryview]":
    """One record as the buffers to write in order: header, points, cats.
    The crc runs over the buffers in place (``zlib.crc32`` chained), so a
    batch is never concatenated into one more copy of itself."""
    pts = np.ascontiguousarray(points, np.float32)
    n, d = pts.shape
    parts = [memoryview(pts.reshape(-1).view(np.uint8))]
    gamma = 0
    if cats is not None:
        carr = np.ascontiguousarray(cats, np.int32).reshape(n, -1)
        parts.append(memoryview(carr.reshape(-1).view(np.uint8)))
        gamma = carr.shape[1]
    prefix = struct.pack("<QIII", seq, n, d, gamma)
    crc = zlib.crc32(prefix)
    for p in parts:
        crc = zlib.crc32(p, crc)
    return [memoryview(_HDR.pack(seq, n, d, gamma, crc & 0xFFFFFFFF))] + parts


class WriteAheadLog:
    """Append-only batch log with CRC-framed records (thread-safe)."""

    def __init__(
        self,
        path: str,
        *,
        fsync: bool = False,
        faults=None,
        registry: Optional[obs.MetricsRegistry] = None,
    ):
        self.path = path
        self.fsync = bool(fsync)
        self.faults = faults
        self._mu = threading.Lock()
        self._f = None
        reg = registry if registry is not None else obs.default_registry()
        self._m_appends = reg.counter("serve.wal.appends")
        self._m_bytes = reg.counter("serve.wal.bytes")
        self._m_append_errors = reg.counter("serve.wal.append_errors")
        self._m_replayed = reg.counter("serve.wal.replayed")
        self._m_torn = reg.counter("serve.wal.torn_records")

    # -- writing -------------------------------------------------------

    def _ensure_open(self):
        if self._f is None:
            fresh = (
                not os.path.exists(self.path)
                or os.path.getsize(self.path) == 0
            )
            self._f = open(self.path, "ab")
            if fresh:
                self._f.write(_MAGIC)
                self._f.flush()

    def append(
        self, seq: int, points: np.ndarray, cats: Optional[np.ndarray]
    ) -> None:
        """Durably append one batch; raises ``WalError`` on any failure
        (injected or real) — the caller must treat the batch as not
        accepted."""
        parts = _frame(seq, points, cats)
        with self._mu:
            try:
                if self.faults is not None:
                    self.faults.check("wal.append")
                self._ensure_open()
                for p in parts:
                    self._f.write(p)
                self._f.flush()
                if self.fsync:
                    os.fsync(self._f.fileno())
            except Exception as e:
                self._m_append_errors.inc()
                raise WalError(
                    f"WAL append of batch seq={seq} failed; the batch is "
                    f"not durable and was not enqueued"
                ) from e
            self._m_appends.inc()
            self._m_bytes.inc(sum(len(p) for p in parts))

    # -- reading -------------------------------------------------------

    def replay(self, after_seq: int = -1) -> Iterator[WalRecord]:
        """Yield whole records with ``seq > after_seq`` in file order.

        Stops (with a warning + ``serve.wal.torn_records``) at the first
        truncated or CRC-corrupt record: that is the torn tail of a
        crash mid-append, never acknowledged to the submitter.
        """
        with self._mu:
            if self._f is not None:
                self._f.flush()
        yield from self._iter_records(after_seq)

    def _iter_records(self, after_seq: int) -> Iterator[WalRecord]:
        """Lock-free file scan (callers flush/serialize as needed)."""
        for seq, n, d, gamma, _hdr, payload in self._scan(after_seq):
            # writable views of the record's own buffer: no more copies
            pts = np.frombuffer(payload, np.float32, n * d).reshape(n, d)
            cats = None
            if gamma:
                cats = np.frombuffer(
                    payload, np.int32, n * gamma, offset=n * d * 4
                ).reshape(n, gamma)
            yield WalRecord(seq=int(seq), points=pts, cats=cats)

    def _scan(self, after_seq: int):
        """Whole records with ``seq > after_seq`` as ``(seq, n, d, gamma,
        header, payload)``, read into one buffer each and crc-checked in
        place; stops at a torn or corrupt record as the reference's scan
        does."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                if magic:
                    self._m_torn.inc()
                    _log.warning("WAL %s: bad magic, ignoring log",
                                 self.path)
                return
            while True:
                hdr = f.read(_HDR.size)
                if not hdr:
                    return
                if len(hdr) < _HDR.size:
                    self._m_torn.inc()
                    _log.warning("WAL %s: torn header at tail", self.path)
                    return
                seq, n, d, gamma, crc = _HDR.unpack(hdr)
                nbytes = n * d * 4 + n * gamma * 4
                payload = bytearray(nbytes)
                if f.readinto(payload) < nbytes:
                    self._m_torn.inc()
                    _log.warning("WAL %s: torn payload at seq %d",
                                 self.path, seq)
                    return
                prefix = struct.pack("<QIII", seq, n, d, gamma)
                got = zlib.crc32(payload, zlib.crc32(prefix)) & 0xFFFFFFFF
                if got != crc:
                    self._m_torn.inc()
                    _log.warning("WAL %s: CRC mismatch at seq %d",
                                 self.path, seq)
                    return
                if seq <= after_seq:
                    continue
                self._m_replayed.inc()
                yield seq, n, d, gamma, hdr, payload

    def last_seq(self) -> int:
        """Highest whole-record seq in the log (-1 when empty)."""
        last = -1
        for rec in self.replay():
            last = rec.seq
        return last

    # -- compaction ----------------------------------------------------

    def compact(self, upto_seq: int) -> None:
        """Atomically drop records with ``seq <= upto_seq`` (they are
        covered by a checkpoint). Each kept record is checked and copied
        as it is on disk, one record in memory at a time. The rewrite
        goes to a temp file that
        replaces the log in one ``os.replace`` — a crash mid-compaction
        leaves the old (superset) log, which replays correctly. The lock
        is held throughout, so a concurrent ``append`` can never land in
        the about-to-be-replaced file and get lost."""
        with self._mu:
            if self._f is not None:
                self._f.flush()
                self._f.close()
                self._f = None
            tmp = self.path + ".compact"
            with open(tmp, "wb") as f:
                f.write(_MAGIC)
                # a kept record's bytes as they are: the reference's
                # re-framing of it writes the same bytes
                for *_fields, hdr, payload in self._scan(upto_seq):
                    f.write(hdr)
                    f.write(payload)
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
            # chaos site: at this point BOTH generations are on disk
            # (old log at self.path, replacement at tmp). A crash here
            # must restore bit-identically from either file.
            if self.faults is not None:
                self.faults.check("wal.compact")
            os.replace(tmp, self.path)

    def close(self) -> None:
        with self._mu:
            if self._f is not None:
                self._f.flush()
                self._f.close()
                self._f = None
