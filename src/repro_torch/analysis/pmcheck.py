"""pmemcheck-style persistence-ordering sanitizer for the simulated NVMM.

A :class:`PMCheck` instance shadows one :class:`repro.core.nvmm.NVMM`
region at cacheline granularity, mirroring the crash model's state
machine (dirty -> flush-requested -> durable) *independently* of the
region's ``track`` flag, and checks the three commit protocols the engine
runs over the region:

* **log group commit** — the 8-byte ``cg = CG_HEAD`` store on a group
  head (``LogShard.append``),
* **frame flip** — the single-cacheline ``_FR`` header store of a mapped
  paged frame (``PagedRegion.frame_write`` / ``truncate_frame``),
* **route/manifest record** — the CRC'd ``_RT_HDR`` store at
  ``route_base`` (``EpochRouter._persist_locked``).

Error codes (collected in :attr:`PMCheck.violations`; the ``--sanitize``
pytest fixture fails a test that accumulated any):

* ``PM001`` — a commit-point store was issued while one or more covered
  payload cachelines were not yet fenced durable (dirty, or pwb'd but no
  fence drained them).  This is the "missing pwb / missing pfence before
  the commit flag" bug class: invisible to crash sampling until the one
  crash that loses exactly those lines.
* ``PM002`` — the committing thread stored into its own commit's covered
  region between the commit-point store and the psync that seals it: the
  store rides the commit's durability attribution without being ordered
  by it.  Scoped to the owner thread: a cross-thread overlap is a legal
  interleaving (the drain retires backend-durable entries without waiting
  for an in-flight commit's psync).
* ``PM004`` — the committing thread issued its sealing fence while the
  commit flag's own cacheline was still dirty (commit store never
  pwb'd): the psync returns with the commit flag not durable.

Perf diagnostics (counted, never errors):

* ``diag_redundant_pwb``  — a ``pwb`` covering no dirty line (the lines
  were already flush-requested or clean): wasted ``clwb`` traffic.
* ``diag_empty_fence``    — a ``pfence``/``psync`` with nothing
  flush-requested: back-to-back fence.

Suppression: pass ``allow={"PM001", ...}`` to :class:`PMCheck` (or use
``pmcheck.suppress("PM001")`` around a block) for protocol code that is
deliberately outside the model — nothing in ``repro.core`` needs it.

Attachment: :func:`attach` wires a PMCheck into one NVMM instance's bound
methods (planted-bug tests use this).  Under ``pytest --sanitize`` the
:mod:`repro.analysis.sanitize` module instead patches the ``NVMM`` base
class so subclass overrides (the crash-fuse NVMMs call ``super()``) are
covered, and binds the region layout when an ``NVLog`` adopts the region.
"""
from __future__ import annotations

import struct
import threading
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.trace import Reporter, Violation, tid
from repro_torch.core.policy import CACHELINE, FRAME_HDR, ROUTE_ENT, ROUTE_HDR, Policy

_U64 = struct.Struct("<Q")

# entry header layout (repro.core.log._HDR): cg, seq, off, fdid, length, nfollow, crc
_HDR = struct.Struct("<QQQIIII")
HDR_SIZE = 48
CG_HEAD = 1
# frame header layout (repro.core.pager._FR): state, slot, page_no, seq, fdid, length, crc
_FR = struct.Struct("<IIQQIII")
FR_MAPPED = 1
# route record header (repro.core.router._RT_HDR): epoch, count, crc
_RT_HDR = struct.Struct("<QII")

_DIRTY = 1
_REQUESTED = 2


# violation records now come from the shared checker plumbing; the old
# name stays importable for the planted-bug suite and external tooling
PMViolation = Violation


class _Window:
    """One open commit: covered payload byte-ranges sealed by the next
    fence (issued by the owner thread) that drains the commit line."""
    __slots__ = ("kind", "commit_off", "commit_len", "covered", "owner")

    def __init__(self, kind: str, commit_off: int, commit_len: int,
                 covered: List[Tuple[int, int]]):
        self.kind = kind
        self.commit_off = commit_off
        self.commit_len = commit_len
        self.covered = covered            # [(start, end)) byte ranges
        self.owner = tid()

    @property
    def commit_line(self) -> int:
        return self.commit_off // CACHELINE


class PMCheck:
    """Shadow state machine + commit-protocol checks for one NVMM."""

    def __init__(self, nvmm, policy: Optional[Policy] = None,
                 allow: Optional[Set[str]] = None):
        self.nvmm = nvmm
        self.policy: Optional[Policy] = None
        self._mu = threading.Lock()       # analysis infra, not a core lock
        self._lines: Dict[int, int] = {}  # line -> _DIRTY | _REQUESTED
        self._windows: List[_Window] = []
        self._rep = Reporter(allow)       # shared sink (dedup by code+msg)
        self.violations = self._rep.violations
        self.allow = self._rep.allow
        self.diag_redundant_pwb = 0
        self.diag_empty_fence = 0
        self.stats_commits = 0
        if policy is not None:
            self.bind(policy)

    # -------------------------------------------------------------- layout
    def bind(self, policy: Policy) -> None:
        """Adopt the region layout; commit-point detection needs it (state
        tracking alone works unbound)."""
        with self._mu:
            self.policy = policy
            self._shard_bytes = policy.entries_per_shard * policy.entry_size
            self._windows.clear()

    # ------------------------------------------------------------- reports
    def _flag(self, code: str, msg: str) -> None:
        self._rep.flag(code, msg)

    def reset(self) -> None:
        with self._mu:
            self._lines.clear()
            self._windows.clear()

    def summary(self) -> dict:
        return {
            "violations": [repr(v) for v in self.violations],
            "commits_checked": self.stats_commits,
            "diag_redundant_pwb": self.diag_redundant_pwb,
            "diag_empty_fence": self.diag_empty_fence,
        }

    def __deepcopy__(self, memo):
        """Deepcopying a shadowed NVMM (the crash-image snapshot idiom in
        the recovery tests) gives the copy a *fresh* shadow: raw locks
        don't survive ``copy.deepcopy``, and the copy's future stores are
        not this shadow's to judge.  The copied image is a crashed one, so
        starting all-durable is exactly right.  Under an active
        ``--sanitize`` session the new shadow registers with it, keeping
        the copy's violations visible to the per-test guard."""
        nvmm = memo.get(id(self.nvmm), self.nvmm)
        pm = PMCheck(nvmm, policy=self.policy, allow=set(self.allow))
        memo[id(self)] = pm
        from repro_torch.analysis import sanitize
        st = sanitize.state_or_none()
        if st is not None:
            st.pmchecks.append(pm)
        return pm

    # ------------------------------------------------------ state helpers
    @staticmethod
    def _lines_of(off: int, n: int):
        return range(off // CACHELINE, (off + max(n, 1) - 1) // CACHELINE + 1)

    def _undurable_lines(self, ranges: List[Tuple[int, int]]) -> List[int]:
        bad = []
        for s, e in ranges:
            for line in self._lines_of(s, e - s):
                if line in self._lines:
                    bad.append(line)
        return bad

    # ------------------------------------------------- commit-point detect
    def _detect_commit(self, off: int, data) -> Optional[_Window]:
        pol = self.policy
        if pol is None:
            return None
        n = len(data)
        buf = self.nvmm._buf
        if n == 8 and off >= pol.entries_base \
                and (off - pol.entries_base) % pol.entry_size == 0 \
                and _U64.unpack(bytes(data[:8]))[0] == CG_HEAD:
            # log group head commit: cover head header+payload and every
            # follower entry (headers at the time of the commit store)
            sid = (off - pol.entries_base) // self._shard_bytes
            base = pol.shard_base(sid)
            slot = (off - base) // pol.entry_size
            nslots = pol.entries_per_shard
            _cg, _seq, _foff, _fdid, length, nfollow, _crc = _HDR.unpack_from(
                buf, off)
            covered = [(off, off + HDR_SIZE + length)]
            for j in range(1, nfollow + 1):
                eoff = base + ((slot + j) % nslots) * pol.entry_size
                flen = _HDR.unpack_from(buf, eoff)[4]
                covered.append((eoff, eoff + HDR_SIZE + flen))
            return _Window("log", off, 8, covered)
        if n == _FR.size and pol.page_frames \
                and pol.page_base <= off < pol.entries_base \
                and (off - pol.page_base) % pol.frame_size == 0:
            state, slot, _pno, _seq, _fdid, length, _crc = _FR.unpack(
                bytes(data[:_FR.size]))
            if state != FR_MAPPED:
                return None               # invalidate/format, not a commit
            doff = off + FRAME_HDR + slot * pol.page_size
            return _Window("frame", off, n, [(doff, doff + length)])
        if n == ROUTE_HDR and off == pol.route_base:
            _epoch, count, _crc = _RT_HDR.unpack(bytes(data[:ROUTE_HDR]))
            payload = (off + ROUTE_HDR, off + ROUTE_HDR + count * ROUTE_ENT)
            return _Window("route", off, n,
                           [payload] if count else [])
        return None

    # ----------------------------------------------------- traced NVMM ops
    def on_store(self, off: int, data) -> None:
        """Called BEFORE the underlying store is applied."""
        n = len(data)
        me = tid()
        with self._mu:
            for w in self._windows:
                # PM002 polices protocol order on the COMMITTING thread only:
                # another thread overlapping the window is legitimate (the
                # drain retires backend-durable entries without waiting for
                # the in-flight commit's psync — its own pfence drains the
                # writer's pwb-requested commit line, so durability holds).
                if w.owner != me:
                    continue
                for s, e in w.covered:
                    if off < e and off + n > s \
                            and not (off >= w.commit_off
                                     and off + n <= w.commit_off + w.commit_len):
                        self._flag("PM002",
                                   f"store [{off},{off + n}) lands inside the "
                                   f"open {w.kind} commit at {w.commit_off} "
                                   f"before its sealing psync")
                        break
            w = self._detect_commit(off, data)
            if w is not None:
                self.stats_commits += 1
                bad = self._undurable_lines(w.covered)
                if bad:
                    self._flag("PM001",
                               f"{w.kind} commit store at {off} with "
                               f"{len(bad)} covered cacheline(s) not fenced "
                               f"durable (lines {bad[:8]})")
                self._windows.append(w)
            for line in self._lines_of(off, n):
                self._lines[line] = _DIRTY

    def on_pwb(self, off: int, n: int = CACHELINE) -> None:
        with self._mu:
            moved = 0
            for line in self._lines_of(off, n):
                if self._lines.get(line) == _DIRTY:
                    self._lines[line] = _REQUESTED
                    moved += 1
            if moved == 0:
                self.diag_redundant_pwb += 1

    def on_fence(self, kind: str) -> None:
        me = tid()
        with self._mu:
            drained = {l for l, st in self._lines.items() if st == _REQUESTED}
            if not drained:
                self.diag_empty_fence += 1
            for line in drained:
                del self._lines[line]
            still_open = []
            for w in self._windows:
                if w.commit_line in drained:
                    continue              # sealed
                if w.owner == me and self._lines.get(w.commit_line) == _DIRTY:
                    self._flag("PM004",
                               f"{kind} by the committing thread with the "
                               f"{w.kind} commit flag at {w.commit_off} "
                               f"still dirty (commit store never pwb'd)")
                still_open.append(w)
            self._windows = still_open

    def on_crash(self) -> None:
        """Power loss: the volatile view collapses onto the durable shadow;
        every in-flight commit window dies with it."""
        self.reset()


# ---------------------------------------------------------------------------
# instance-level attachment (planted-bug tests; sanitize.py patches the
# NVMM *class* instead so crash-fuse subclasses are covered)

def attach(nvmm, policy: Optional[Policy] = None,
           allow: Optional[Set[str]] = None) -> PMCheck:
    """Wrap one NVMM instance's ``store``/``pwb``/``pfence``/``psync``/
    ``crash`` bound methods with a fresh :class:`PMCheck`.  Only sound for
    instances whose class does not override those methods (the crash-fuse
    subclasses do — use :mod:`repro.analysis.sanitize` for them)."""
    pm = PMCheck(nvmm, policy=policy, allow=allow)
    from repro_torch.analysis import sanitize
    if sanitize.state_or_none() is not None and hasattr(nvmm, "_pm"):
        # ``sanitize.install()``'s class-level hooks already route every
        # store/pwb/fence through ``nvmm._pm`` — rebind that slot instead of
        # stacking instance wrappers on top (which would deliver every event
        # twice: once from the wrapper, once from the patched class method).
        nvmm._pm = pm
        return pm
    orig_store, orig_pwb = nvmm.store, nvmm.pwb
    orig_pfence, orig_psync, orig_crash = nvmm.pfence, nvmm.psync, nvmm.crash

    def store(off, data):
        pm.on_store(off, data)
        return orig_store(off, data)

    def pwb(off, n=CACHELINE):
        pm.on_pwb(off, n)
        return orig_pwb(off, n)

    def pfence():
        pm.on_fence("pfence")
        return orig_pfence()

    def psync():
        pm.on_fence("psync")
        return orig_psync()

    def crash(choose_evicted=None):
        pm.on_crash()
        return orig_crash(choose_evicted)

    nvmm.store, nvmm.pwb = store, pwb
    nvmm.pfence, nvmm.psync, nvmm.crash = pfence, psync, crash
    nvmm._pm = pm
    return pm
