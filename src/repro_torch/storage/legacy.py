"""Legacy-application workload models: SQLite-style and RocksDB-style
crash-consistency protocols over plain file operations (paper §IV).

The paper's §IV experiments run *unmodified* SQLite and RocksDB over
NVCache.  What makes those applications interesting for a cache claiming
synchronous durability is not their data plane — it is their **metadata
protocols**: every one of them turns a multi-write transaction into an
atomic event through a namespace operation the kernel promises to be
atomic.  These models reproduce exactly those protocols, small enough to
fuse-crash at every step (tests/test_legacy_crash.py) and fast enough to
benchmark (benchmarks/fig3_dbbench.py):

* :class:`SQLiteRollbackDB` — rollback-journal mode (SQLite's default
  ``journal_mode=DELETE``): before touching the database, the *original*
  images of every page a transaction modifies are written to a side
  journal and fsynced; the database pages are then updated in place and
  fsynced; the **unlink of the journal is the commit point**.  Recovery
  ("hot journal" detection): a surviving journal with a valid header means
  the transaction did not commit — roll the original pages back and delete
  the journal.
* :class:`SQLiteWALDB` — write-ahead-log mode: a transaction appends page
  frames plus a commit frame to the WAL and fsyncs it (the database is
  untouched); a checkpoint copies committed frames into the database,
  fsyncs it, then **resets the WAL with an ftruncate-to-zero**.  Recovery:
  replay every whole committed transaction from the WAL, ignore the torn
  tail.
* :class:`RocksLite` — LSM-style: synchronous puts append CRC'd records to
  a numbered WAL; a flush writes the memtable to an SST file, then
  **renames a freshly-written MANIFEST into place** — the install point
  that atomically switches the live file set to {SSTs, new WAL} — and
  unlinks the old WAL.  Recovery: read the MANIFEST (or start empty), load
  the SSTs it lists, replay the current WAL up to the first torn record.

All three run over the :class:`repro.storage.fsapi.FS` protocol, so the
same unmodified code drives ``NVCacheFS`` (the paper's stack: fsync free,
namespace ops journaled in NVMM) and ``TierFS`` (the legacy baselines).

Each model doubles as its own **crash-consistency oracle**: database pages
carry content deterministic in (txn, page), page 0 carries the committed
transaction counter, and :meth:`check_consistent` verifies that the state
observed after crash + recovery is the one produced by a legal prefix of
transactions — every acknowledged transaction present, the in-flight one
whole or absent, never a torn mix.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

from repro_torch.storage.fsapi import FS

# ---------------------------------------------------------------------------
# deterministic page/transaction content: the oracle's ground truth


def page_content(txn: int, page_no: int, page_size: int) -> bytes:
    """Deterministic content of ``page_no`` as written by ``txn``."""
    seed = (txn * 1_000_003 + page_no) & 0xFFFFFFFF
    unit = struct.pack("<IIQ", txn, page_no, seed)
    return (unit * (page_size // len(unit) + 1))[:page_size]


def touched_pages(txn: int, npages: int, spread: int = 3) -> List[int]:
    """Deterministic page set of transaction ``txn`` (pages 1..npages-1;
    page 0 is the header)."""
    if npages <= 1:
        return []
    rng = txn * 2_654_435_761
    out = []
    for i in range(spread):
        rng = (rng * 6_364_136_223_846_793_005 + 1_442_695_040_888_963_407) \
            & (2 ** 64 - 1)
        out.append(1 + (rng >> 33) % (npages - 1))
    return sorted(set(out))


def expected_pages(t_star: int, npages: int) -> Dict[int, int]:
    """page_no -> the txn whose content the page holds after txns 1..t_star
    (0 == never written: all zeros)."""
    last: Dict[int, int] = {p: 0 for p in range(1, npages)}
    for t in range(1, t_star + 1):
        for p in touched_pages(t, npages):
            last[p] = t
    return last


_HDRPAGE = struct.Struct("<QI")     # committed txn counter, crc32(counter)


def header_bytes(txn: int, page_size: int) -> bytes:
    raw = _HDRPAGE.pack(txn, zlib.crc32(struct.pack("<Q", txn)))
    return raw + b"\x00" * (page_size - len(raw))


def parse_header(raw: bytes) -> Optional[int]:
    """The committed txn counter, or None if the header page is torn."""
    if len(raw) < _HDRPAGE.size:
        return 0 if not any(raw) else None
    txn, crc = _HDRPAGE.unpack_from(raw)
    if txn == 0 and crc == 0:
        return 0
    return txn if zlib.crc32(struct.pack("<Q", txn)) == crc else None


# ---------------------------------------------------------------------------
class SQLiteRollbackDB:
    """SQLite rollback-journal mode (``journal_mode=DELETE``).

    Commit protocol per transaction (paper §IV's db_bench synchronous
    mode):

    1. write the original images of every page about to change (header
       page included) to ``<db>-journal`` — body first, magic header last
       — and fsync it: the undo log is durable before the db is touched;
    2. write the new page images into the database and fsync it;
    3. **unlink the journal — the commit point.**

    A crash before (3) leaves a hot journal; :meth:`__init__` rolls the
    original pages back (the transaction never happened).  A crash after
    (3) keeps the transaction.  Either way the database equals a legal
    prefix — what :meth:`check_consistent` verifies.
    """

    MAGIC = 0x4A524E4C          # "JRNL"
    _JHDR = struct.Struct("<II")       # magic, page count
    _JREC = struct.Struct("<I")        # page_no (+ page image)

    def __init__(self, fs: FS, path: str = "/app.db", *,
                 page_size: int = 512, npages: int = 8):
        self.fs = fs
        self.path = path
        self.jpath = path + "-journal"
        self.page_size = page_size
        self.npages = npages
        self._recover()
        self.fd = fs.open(path)
        if fs.size(self.fd) == 0:
            fs.pwrite(self.fd, header_bytes(0, page_size), 0)
            fs.fsync(self.fd)

    # ------------------------------------------------------------ recovery
    def _recover(self) -> None:
        """Hot-journal detection + rollback (SQLite's pager recovery)."""
        if not self.fs.exists(self.jpath):
            return
        jfd = self.fs.open(self.jpath)
        try:
            jsize = self.fs.size(jfd)
            hdr = self.fs.pread(jfd, self._JHDR.size, 0)
            if len(hdr) < self._JHDR.size:
                return                      # header never landed: cold
            magic, count = self._JHDR.unpack(hdr)
            rec = self._JREC.size + self.page_size
            if magic != self.MAGIC or jsize < self._JHDR.size + count * rec:
                return                      # torn/cold journal: db untouched
            dbfd = self.fs.open(self.path)
            try:
                for i in range(count):
                    off = self._JHDR.size + i * rec
                    pno, = self._JREC.unpack(
                        self.fs.pread(jfd, self._JREC.size, off))
                    img = self.fs.pread(jfd, self.page_size,
                                        off + self._JREC.size)
                    img = img + b"\x00" * (self.page_size - len(img))
                    self.fs.pwrite(dbfd, img, pno * self.page_size)
                self.fs.fsync(dbfd)
            finally:
                self.fs.close(dbfd)
        finally:
            self.fs.close(jfd)
            self.fs.unlink(self.jpath)

    # -------------------------------------------------------------- commit
    def commit(self, txn: int) -> None:
        ps = self.page_size
        pages = touched_pages(txn, self.npages)
        # 1. journal the ORIGINAL images (header page too) and fsync.
        #    Body before header: a journal without its magic is cold.
        jfd = self.fs.open(self.jpath)
        off = self._JHDR.size
        for pno in [0] + pages:
            orig = self.fs.pread(self.fd, ps, pno * ps)
            orig = orig + b"\x00" * (ps - len(orig))
            self.fs.pwrite(jfd, self._JREC.pack(pno) + orig, off)
            off += self._JREC.size + ps
        self.fs.pwrite(jfd, self._JHDR.pack(self.MAGIC, 1 + len(pages)), 0)
        self.fs.fsync(jfd)
        # 2. update the database in place, fsync
        for pno in pages:
            self.fs.pwrite(self.fd, page_content(txn, pno, ps), pno * ps)
        self.fs.pwrite(self.fd, header_bytes(txn, ps), 0)
        self.fs.fsync(self.fd)
        # 3. commit point: delete the journal — while it is still OPEN,
        #    exactly like SQLite's pager (POSIX keeps the anonymous file
        #    alive until the close below, which costs nothing)
        self.fs.unlink(self.jpath)
        self.fs.close(jfd)

    def close(self) -> None:
        self.fs.close(self.fd)

    # -------------------------------------------------------------- oracle
    def observed_txn(self) -> Optional[int]:
        return parse_header(self.fs.pread(self.fd, self.page_size, 0))

    def check_consistent(self, acked: int, started: int) -> int:
        """After crash + recovery: the db must equal the state after txns
        1..t* for a single t* with acked <= t* <= started.  Returns t*."""
        t_star = self.observed_txn()
        assert t_star is not None, "torn header page"
        assert acked <= t_star <= started, \
            f"t*={t_star} outside [{acked}, {started}]"
        ps = self.page_size
        for pno, towner in expected_pages(t_star, self.npages).items():
            got = self.fs.pread(self.fd, ps, pno * ps)
            got = got + b"\x00" * (ps - len(got))
            want = page_content(towner, pno, ps) if towner else b"\x00" * ps
            assert got == want, \
                f"page {pno}: holds neither pre- nor post-t*={t_star} bytes"
        assert not self.fs.exists(self.jpath), "journal survived recovery"
        return t_star


# ---------------------------------------------------------------------------
class SQLiteWALDB:
    """SQLite WAL mode: append-only commits, checkpoint truncates the WAL.

    A transaction appends one frame per modified page plus a CRC'd commit
    frame, then fsyncs the WAL (``synchronous=FULL``); readers overlay
    committed frames over the database.  ``checkpoint()`` copies the
    latest committed frames into the database, fsyncs it, and resets the
    WAL with **ftruncate(0)** — the metadata op whose durability NVCache
    must guarantee: losing it resurrects stale frames; tearing it corrupts
    the overlay.
    """

    _FRAME = struct.Struct("<IQI")      # page_no, txn, crc32(data)
    COMMIT = 0xFFFFFFFF                 # commit frame's page_no

    def __init__(self, fs: FS, path: str = "/app.db", *,
                 page_size: int = 512, npages: int = 8):
        self.fs = fs
        self.path = path
        self.wpath = path + "-wal"
        self.page_size = page_size
        self.npages = npages
        self.fd = fs.open(path)
        self.wfd = fs.open(self.wpath)
        if fs.size(self.fd) == 0:
            fs.pwrite(self.fd, header_bytes(0, page_size), 0)
            fs.fsync(self.fd)
        self._index: Dict[int, int] = {}    # page_no -> wal offset of data
        self._wal_end = 0
        self._recover()

    # ------------------------------------------------------------ recovery
    def _recover(self) -> None:
        """Replay whole committed transactions; ignore the torn tail."""
        size = self.fs.size(self.wfd)
        ps, fs_ = self.page_size, self.fs
        frame = self._FRAME.size + ps
        off = 0
        pending: Dict[int, int] = {}
        while off + self._FRAME.size <= size:
            pno, txn, crc = self._FRAME.unpack(
                fs_.pread(self.wfd, self._FRAME.size, off))
            if pno == self.COMMIT:
                # commit frame carries no page image
                if crc != zlib.crc32(struct.pack("<QI", txn, len(pending))):
                    break                    # torn commit: stop
                self._index.update(pending)
                pending.clear()
                off += self._FRAME.size
                self._wal_end = off
                continue
            if off + frame > size or pno >= self.npages:
                break                        # torn data frame
            data = fs_.pread(self.wfd, ps, off + self._FRAME.size)
            if zlib.crc32(bytes(data)) != crc:
                break
            pending[pno] = off + self._FRAME.size
            off += frame
        # uncommitted tail frames (pending) are discarded; the next commit
        # overwrites them at _wal_end

    # ------------------------------------------------------------ data ops
    def _read_page(self, pno: int) -> bytes:
        woff = self._index.get(pno)
        if woff is not None:
            raw = self.fs.pread(self.wfd, self.page_size, woff)
        else:
            raw = self.fs.pread(self.fd, self.page_size, pno * self.page_size)
        return raw + b"\x00" * (self.page_size - len(raw))

    def commit(self, txn: int) -> None:
        ps = self.page_size
        pages = touched_pages(txn, self.npages)
        off = self._wal_end
        staged: Dict[int, int] = {}
        for pno in pages + [0]:
            data = (page_content(txn, pno, ps) if pno
                    else header_bytes(txn, ps))
            hdr = self._FRAME.pack(pno, txn, zlib.crc32(data))
            self.fs.pwrite(self.wfd, hdr + data, off)
            staged[pno] = off + self._FRAME.size
            off += self._FRAME.size + ps
        nframes = len(pages) + 1
        commit = self._FRAME.pack(
            self.COMMIT, txn, zlib.crc32(struct.pack("<QI", txn, nframes)))
        self.fs.pwrite(self.wfd, commit, off)
        self.fs.fsync(self.wfd)              # durable == committed
        self._wal_end = off + self._FRAME.size
        self._index.update(staged)

    def checkpoint(self) -> None:
        """Copy committed frames into the db, then reset the WAL."""
        if not self._index:
            return
        for pno, woff in sorted(self._index.items()):
            raw = self.fs.pread(self.wfd, self.page_size, woff)
            self.fs.pwrite(self.fd, raw, pno * self.page_size)
        self.fs.fsync(self.fd)               # db durable BEFORE the reset
        self.fs.ftruncate(self.wfd, 0)       # WAL reset (the metadata op)
        self.fs.fsync(self.wfd)
        self._index.clear()
        self._wal_end = 0

    def close(self) -> None:
        self.fs.close(self.wfd)
        self.fs.close(self.fd)

    # -------------------------------------------------------------- oracle
    def observed_txn(self) -> Optional[int]:
        return parse_header(self._read_page(0))

    def check_consistent(self, acked: int, started: int) -> int:
        t_star = self.observed_txn()
        assert t_star is not None, "torn header"
        assert acked <= t_star <= started, \
            f"t*={t_star} outside [{acked}, {started}]"
        ps = self.page_size
        for pno, towner in expected_pages(t_star, self.npages).items():
            got = self._read_page(pno)
            want = page_content(towner, pno, ps) if towner else b"\x00" * ps
            assert got == want, \
                f"page {pno}: neither pre- nor post-t*={t_star} bytes"
        return t_star


# ---------------------------------------------------------------------------
class RocksLite:
    """RocksDB-style LSM shell: synchronous WAL + rename-installed MANIFEST.

    ``put`` appends a CRC'd record to the current WAL and fsyncs (db_bench
    sync mode).  ``flush`` persists the memtable as an SST, then writes the
    new MANIFEST — the list of live SSTs plus the current WAL number — to a
    temp file and **renames it over /MANIFEST**: the rename is the atomic
    install that simultaneously publishes the SST and retires the old WAL,
    which is unlinked afterwards.  Crash anywhere: the MANIFEST read at
    open names a consistent (SSTs, WAL) pair, and an unlinked WAL must
    never resurrect (its records would double-apply over the SST).
    """

    _REC = struct.Struct("<III")        # crc32(key+val), klen, vlen

    def __init__(self, fs: FS, root: str = "/rocks"):
        self.fs = fs
        self.root = root
        self.mpath = root + "/MANIFEST"
        self.map: Dict[bytes, bytes] = {}
        self.ssts: List[str] = []
        self.wal_num = 1
        self.sst_num = 0
        if fs.exists(self.mpath):
            self._load_manifest()
        for sst in self.ssts:
            self._load_sst(sst)
        valid_end = self._replay_wal(self._wal_path(self.wal_num))
        self.wfd = fs.open(self._wal_path(self.wal_num))
        # append after the last WHOLE record: a torn tail is dead bytes the
        # next put must overwrite, or every later replay would stop there
        self.wal_end = valid_end

    def _wal_path(self, n: int) -> str:
        return f"{self.root}/wal-{n:06d}"

    # ----------------------------------------------------------- manifest
    def _load_manifest(self) -> None:
        fd = self.fs.open_ro(self.mpath)
        try:
            raw = self.fs.pread(fd, self.fs.size(fd), 0)
        finally:
            self.fs.close(fd)
        for line in bytes(raw).decode().splitlines():
            if line.startswith("sst:"):
                self.ssts.append(line[4:])
                self.sst_num = max(self.sst_num,
                                   int(line.rsplit("-", 1)[1]))
            elif line.startswith("wal:"):
                self.wal_num = int(line[4:])

    def _load_sst(self, path: str) -> None:
        fd = self.fs.open_ro(path)
        try:
            size = self.fs.size(fd)
            off = 0
            while off + self._REC.size <= size:
                crc, klen, vlen = self._REC.unpack(
                    self.fs.pread(fd, self._REC.size, off))
                kv = self.fs.pread(fd, klen + vlen, off + self._REC.size)
                self.map[bytes(kv[:klen])] = bytes(kv[klen:])
                off += self._REC.size + klen + vlen
        finally:
            self.fs.close(fd)

    def _replay_wal(self, path: str) -> int:
        """Apply the WAL's whole, CRC-valid records; returns the offset
        just past the last one (the append point)."""
        if not self.fs.exists(path):
            return 0
        fd = self.fs.open_ro(path)
        try:
            size = self.fs.size(fd)
            off = 0
            while off + self._REC.size <= size:
                crc, klen, vlen = self._REC.unpack(
                    self.fs.pread(fd, self._REC.size, off))
                if off + self._REC.size + klen + vlen > size:
                    break                    # torn tail record
                kv = bytes(self.fs.pread(fd, klen + vlen,
                                         off + self._REC.size))
                if zlib.crc32(kv) != crc:
                    break                    # torn tail record
                self.map[kv[:klen]] = kv[klen:]
                off += self._REC.size + klen + vlen
            return off
        finally:
            self.fs.close(fd)

    # ------------------------------------------------------------ data ops
    def put(self, key: bytes, val: bytes) -> None:
        rec = self._REC.pack(zlib.crc32(key + val), len(key), len(val)) \
            + key + val
        self.fs.pwrite(self.wfd, rec, self.wal_end)
        self.fs.fsync(self.wfd)              # sync mode: durable on return
        self.wal_end += len(rec)
        self.map[key] = val

    def get(self, key: bytes) -> Optional[bytes]:
        return self.map.get(key)

    def flush(self) -> None:
        """Memtable -> SST, MANIFEST rename-install, old WAL unlink."""
        self.sst_num += 1
        sst = f"{self.root}/sst-{self.sst_num:06d}"
        fd = self.fs.open(sst)
        off = 0
        for k in sorted(self.map):
            v = self.map[k]
            rec = self._REC.pack(zlib.crc32(k + v), len(k), len(v)) + k + v
            self.fs.pwrite(fd, rec, off)
            off += len(rec)
        self.fs.fsync(fd)
        self.fs.close(fd)
        old_wal = self._wal_path(self.wal_num)
        self.wal_num += 1
        body = (f"sst:{sst}\nwal:{self.wal_num}\n").encode()
        tmp = self.mpath + ".tmp"
        tfd = self.fs.open(tmp)
        self.fs.ftruncate(tfd, 0)            # the path may hold a stale tmp
        self.fs.pwrite(tfd, body, 0)
        self.fs.fsync(tfd)
        self.fs.close(tfd)
        self.fs.close(self.wfd)
        self.fs.rename(tmp, self.mpath)      # the atomic install point
        self.fs.unlink(old_wal)              # records now live in the SST
        for obsolete in self.ssts:           # superseded by the merged SST
            self.fs.unlink(obsolete)
        self.ssts = [sst]
        self.wfd = self.fs.open(self._wal_path(self.wal_num))
        self.wal_end = 0

    def close(self) -> None:
        self.fs.close(self.wfd)

    # -------------------------------------------------------------- oracle
    @staticmethod
    def kv(i: int) -> Tuple[bytes, bytes]:
        """Deterministic key/value of the i-th put (keys collide mod 7 so
        overwrites are exercised)."""
        key = f"key-{i % 7}".encode()
        val = struct.pack("<I", i) * 5
        return key, val

    def check_consistent(self, acked: int, started: int,
                         flushed_wals: List[str]) -> int:
        """The reopened map must equal the state after puts 1..m for one m
        with acked <= m <= started; acked-unlinked WALs must stay gone."""
        # reconstruct candidate states and match
        want: Dict[bytes, bytes] = {}
        match = None
        for m in range(0, started + 1):
            if m:
                k, v = self.kv(m)
                want[k] = v
            if m >= acked and self.map == want:
                match = m
                break
        assert match is not None, \
            f"map matches no legal prefix in [{acked}, {started}]"
        for wal in flushed_wals:
            assert not self.fs.exists(wal), f"unlinked WAL {wal} resurrected"
        return match
