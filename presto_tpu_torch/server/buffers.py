"""Output buffers: in-memory pages with a disk spooling tier.

Counterpart of presto_tpu/server/buffers.py (SpoolingOutputBuffer.java):
when a task's finished result pages outgrow the memory budget, the
tail goes to one append-only spool file per buffer, and readers get
the pages back from it transparently. Acked pages release memory at
once and disk space when the buffer clears (task end). A worker's
graceful drain moves a buffer's live pages to a peer: `export_pages`
writes them as base64 strings (the migration's wire format),
`restore_pages` appends them on the peer, and `stream_checksum` is the
order-sensitive digest that shows the pages arrived once and intact.
"""

from __future__ import annotations

import base64
import hashlib
import os
import tempfile
from typing import List, Optional

__all__ = ["SpoolingOutputBuffer"]


class SpoolingOutputBuffer:
    """A list of pages whose entries past the memory budget live in the
    spool file. Not thread-safe by itself: callers hold the task lock."""

    # tpulint C001: the caller-holds-the-task-lock contract, declared
    # (writes through self in here are the contract body; any OTHER
    # receiver mutating these fields must hold SOME lock)
    _GUARDED_BY = {"<caller>": ("_entries", "_mem_bytes",
                                "_spooled_bytes", "_file",
                                "_file_path")}

    def __init__(self, memory_threshold_bytes: int = 64 << 20,
                 spool_dir: Optional[str] = None):
        self.memory_threshold = memory_threshold_bytes
        self.spool_dir = spool_dir
        # entry: bytes (in memory) or (offset, length) in the spool file
        self._entries: List[object] = []
        self._mem_bytes = 0
        self._spooled_bytes = 0
        self._file = None
        self._file_path: Optional[str] = None

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def spooled_bytes(self) -> int:
        return self._spooled_bytes

    def _spool_file(self):
        if self._file is None:
            fd, self._file_path = tempfile.mkstemp(
                prefix="presto-tpu-spool-", suffix=".pages",
                dir=self.spool_dir)
            self._file = os.fdopen(fd, "wb+")
        return self._file

    def append(self, page: bytes) -> None:
        if self._mem_bytes + len(page) > self.memory_threshold:
            f = self._spool_file()
            f.seek(0, os.SEEK_END)
            off = f.tell()
            f.write(page)
            f.flush()
            self._entries.append((off, len(page)))
            self._spooled_bytes += len(page)
        else:
            self._entries.append(page)
            self._mem_bytes += len(page)

    def extend(self, pages) -> None:
        for p in pages:
            self.append(p)

    def get(self, idx: int) -> bytes:
        e = self._entries[idx]
        if isinstance(e, tuple):
            off, length = e
            self._file.seek(off)
            return self._file.read(length)
        return e

    def stream_checksum(self) -> str:
        """SHA-256 over the live pages in order, each preceded by its
        length (8 bytes, little-endian): equal before a migration and
        after it when every page moved once, byte for byte."""
        h = hashlib.sha256()
        for i in range(len(self._entries)):
            page = self.get(i)
            h.update(len(page).to_bytes(8, "little"))
            h.update(page)
        return h.hexdigest()

    def export_pages(self) -> List[str]:
        """The live (unacked) pages as base64 strings, spooled ones
        read back from the spool file; the acked prefix is gone and is
        not exported, so a consumer resuming mid-stream never re-reads
        a page."""
        return [base64.b64encode(self.get(i)).decode("ascii")
                for i in range(len(self._entries))]

    def restore_pages(self, encoded: List[str]) -> int:
        """Append a migrated page stream (export_pages' output) and
        return its bytes; pages past the memory budget spool here as
        any append does."""
        total = 0
        for s in encoded:
            page = base64.b64decode(s)
            self.append(page)
            total += len(page)
        return total

    def drop_prefix(self, n: int) -> None:
        """Release the first n pages (the consumer acked them): memory
        now, spool-file space at clear()."""
        for e in self._entries[:n]:
            if isinstance(e, bytes):
                self._mem_bytes -= len(e)
            else:
                self._spooled_bytes -= e[1]
        del self._entries[:n]

    def clear(self) -> None:
        self._entries = []
        self._mem_bytes = 0
        self._spooled_bytes = 0
        if self._file is not None:
            try:
                self._file.close()
                os.unlink(self._file_path)
            except OSError:
                pass
            self._file = None
            self._file_path = None

    def __del__(self):  # best-effort spool reclamation
        try:
            self.clear()
        except Exception:  # tpulint: disable=S001 - interpreter
            # teardown: logging/metrics modules may already be gone
            pass
