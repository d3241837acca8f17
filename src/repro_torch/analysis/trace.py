"""Shared plumbing for the runtime checkers (pmcheck, lockcheck,
racecheck): violation records, a deduplicating thread-safe reporter, and
the thread-identity helpers every checker needs.

The three checkers attach from the outside and must never raise inside
an engine thread (a drain thread that dies hangs the pool), so they all
follow the same record-don't-raise discipline.  This module is that
discipline, factored once:

* :class:`Violation` — one finding: code, human message, the thread that
  produced it (captured at flag time — by teardown the thread is gone).
* :class:`Reporter` — append-only violation sink with an ``allow`` set
  (suppression by code) and first-occurrence dedup by an arbitrary
  hashable key, under its own raw mutex (NOT a traced lock: checkers run
  inside traced-lock critical sections and must not re-enter the
  tracer).
* :func:`tid` / :func:`tname` — the ``threading.get_ident()`` /
  current-thread-name pair previously re-derived in each checker.
"""
from __future__ import annotations

import threading
from typing import Hashable, List, Optional, Set


def tid() -> int:
    """Identity of the calling thread (stable while the thread lives)."""
    return threading.get_ident()


def tname() -> str:
    """Best-effort human name of the calling thread."""
    return threading.current_thread().name


class Violation:
    """One checker finding."""

    __slots__ = ("code", "msg", "thread")

    def __init__(self, code: str, msg: str, thread: Optional[str] = None):
        self.code = code
        self.msg = msg
        self.thread = thread if thread is not None else tname()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{self.code}[{self.thread}] {self.msg}"

    def __str__(self) -> str:
        return f"{self.code}: {self.msg} (thread {self.thread})"


class Reporter:
    """Thread-safe, deduplicating violation sink.

    ``allow`` suppresses whole codes; ``flag`` drops repeats of the same
    ``key`` (default: the ``(code, msg)`` pair) so a racy loop produces
    one report, not thousands.  Uses a raw ``threading.Lock`` on
    purpose — see the module docstring.
    """

    def __init__(self, allow: Optional[Set[str]] = None):
        self.allow: Set[str] = set(allow or ())
        self.violations: List[Violation] = []
        self._seen: Set[Hashable] = set()
        self._mu = threading.Lock()

    def flag(self, code: str, msg: str,
             key: Optional[Hashable] = None) -> bool:
        """Record one violation; returns True when it was new (not
        suppressed, not a dup)."""
        if code in self.allow:
            return False
        k = key if key is not None else (code, msg)
        with self._mu:
            if k in self._seen:
                return False
            self._seen.add(k)
            self.violations.append(Violation(code, msg))
            return True

    def mark(self) -> int:
        """Current length, for per-test slicing (``violations[mark:]``)."""
        with self._mu:
            return len(self.violations)

    def since(self, mark: int) -> List[Violation]:
        with self._mu:
            return list(self.violations[mark:])

    def reset_dedup(self) -> None:
        """Forget dedup keys (each test deserves its own first report)."""
        with self._mu:
            self._seen.clear()
