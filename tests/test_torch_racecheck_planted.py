"""The twin of ``tests/test_racecheck_planted.py`` on the port's engine copy
(``repro_torch``), the same cases against the same bars.

Planted-bug suite for the guarded-by race detector (repro_torch.analysis).

Two halves, one acceptance bar each (the pmcheck suite's structure):

* **zero false positives** — real engine paths (multi-writer traffic,
  stats aggregation, drain hand-offs, shutdown) run clean under an armed
  :class:`~repro_torch.analysis.racecheck.RaceCheck`;
* **zero false negatives** — deterministic mutations (guard dropped,
  lock released early, unsynchronized publish) each trip exactly the
  expected RC code, and their correctly-synchronized mirrors run clean.

Interleavings are forced with *plain* ``threading.Semaphore`` hand-offs:
the detector never hooks raw semaphores, so they order execution in real
time without creating a happens-before edge — exactly the shape of a
"works on my machine" race.  Each racing pair ends on an (equally
untraced) ``threading.Barrier`` so both threads are alive until both
accesses are recorded — a thread that exits early can donate its OS
ident to the next one started, which would merge the two accesses into
one thread and hide the plant (the detector's documented ident-reuse
blind spot).  The static half plants L004/L005 snippets through
:func:`repro_torch.analysis.lint.lint_file`.

Every toy class is instrumented inside the test and de-instrumented in a
``finally`` so nothing leaks into the session (under ``--sanitize`` the
planted races stay in the local detector — the ``arm()`` contract).
"""
import ast
import threading
from pathlib import Path

from repro_torch.analysis import lint, racecheck
from repro_torch.core import NVCache, Policy, locking
from repro_torch.storage.tiers import DRAM, Tier
from _torch_engine import full_scan_guard  # noqa: F401


def codes(rc):
    return [v.code for v in rc.violations]


def run2(*fns):
    """Start the given thunks as threads and join them all."""
    ts = [threading.Thread(target=fn, name=f"planted-{i}")
          for i, fn in enumerate(fns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


# ------------------------------------------------------- planted: runtime


def test_planted_write_write_no_sync_rc001():
    """Two threads blindly store the same HB-only field: RC001."""
    class Toy:
        GUARDED_BY = {"x": None}

        def __init__(self):
            self.x = 0

    racecheck.instrument(Toy)
    try:
        with racecheck.arm() as rc:
            toy = Toy()
            gate = threading.Semaphore(0)
            end = threading.Barrier(2)

            def a():
                toy.x = 1
                gate.release()
                end.wait()

            def b():
                gate.acquire()
                toy.x = 2
                end.wait()

            run2(a, b)
        assert "RC001" in codes(rc), codes(rc)
    finally:
        racecheck.deinstrument(Toy)


def test_planted_publish_without_edge_rc002():
    """Writer publishes, reader consumes with no join/lock/event: RC002."""
    class Toy:
        GUARDED_BY = {"x": None}

        def __init__(self):
            self.x = 0

    racecheck.instrument(Toy)
    try:
        with racecheck.arm() as rc:
            toy = Toy()
            gate = threading.Semaphore(0)
            end = threading.Barrier(2)
            out = []

            def w():
                toy.x = 7
                gate.release()
                end.wait()

            def r():
                gate.acquire()
                out.append(toy.x)
                end.wait()

            run2(w, r)
        assert "RC002" in codes(rc), codes(rc)
        assert out == [7]
    finally:
        racecheck.deinstrument(Toy)


def test_planted_guard_dropped_rc003():
    """One reader honors the declared guard, the other skips it.  Reads
    carry no lock edge between the two threads, so the accesses are
    genuinely unordered — the contract violation RC003 exists for."""
    class Toy:
        GUARDED_BY = {"x": "lock"}

        def __init__(self):
            self.lock = locking.make_lock("leaf:lru")
            self.x = 0

    racecheck.instrument(Toy)
    try:
        with racecheck.arm() as rc:
            toy = Toy()
            gate = threading.Semaphore(0)
            end = threading.Barrier(2)

            def disciplined():
                with toy.lock:
                    _ = toy.x
                gate.release()
                end.wait()

            def sloppy():
                gate.acquire()
                _ = toy.x          # guard dropped — the planted bug
                end.wait()

            run2(disciplined, sloppy)
        assert "RC003" in codes(rc), codes(rc)
    finally:
        racecheck.deinstrument(Toy)


def test_planted_lock_released_early_rc003():
    """Double-checked read: a thread samples the field under the guard,
    releases, and re-reads it bare after a concurrent guarded write —
    the bare re-check is unordered against that write (the thread last
    saw the lock's clock *before* the writer held it)."""
    class Toy:
        GUARDED_BY = {"x": "lock"}

        def __init__(self):
            self.lock = locking.make_lock("leaf:lru")
            self.x = 0

    racecheck.instrument(Toy)
    try:
        with racecheck.arm() as rc:
            toy = Toy()
            wrote = threading.Semaphore(0)
            sampled = threading.Semaphore(0)
            end = threading.Barrier(2)

            def early():
                with toy.lock:
                    _ = toy.x       # disciplined first sample...
                sampled.release()
                wrote.acquire()
                _ = toy.x           # ...re-checked after letting go
                end.wait()

            def writer():
                sampled.acquire()
                with toy.lock:
                    toy.x = 1
                wrote.release()
                end.wait()

            run2(early, writer)
        assert "RC003" in codes(rc), codes(rc)
    finally:
        racecheck.deinstrument(Toy)


# ------------------------------------------------- mirrors: must run clean


def test_mirror_lock_discipline_clean():
    """Same write-write shape as the RC001 plant, but both writers hold
    the declared lock: common lockset + release/acquire edge — clean."""
    class Toy:
        GUARDED_BY = {"x": "lock"}

        def __init__(self):
            self.lock = locking.make_lock("leaf:lru")
            self.x = 0

    racecheck.instrument(Toy)
    try:
        with racecheck.arm() as rc:
            toy = Toy()

            def w(v):
                def fn():
                    for _ in range(50):
                        with toy.lock:
                            toy.x += v
                return fn

            run2(w(1), w(2))
            with toy.lock:
                assert toy.x == 150
        assert codes(rc) == [], codes(rc)
    finally:
        racecheck.deinstrument(Toy)


def test_mirror_lock_edge_orders_unguarded_read():
    """HB through a lock channel: the reader bounces through the writer's
    lock before its raw read, so release→acquire orders the accesses."""
    class Toy:
        GUARDED_BY = {"x": None}

        def __init__(self):
            self.lock = locking.make_lock("leaf:lru")
            self.x = 0

    racecheck.instrument(Toy)
    try:
        with racecheck.arm() as rc:
            toy = Toy()
            gate = threading.Semaphore(0)

            def w():
                with toy.lock:
                    toy.x = 3
                gate.release()

            def r():
                gate.acquire()
                with toy.lock:
                    pass            # pick up the writer's clock
                assert toy.x == 3
            run2(w, r)
        assert codes(rc) == [], codes(rc)
    finally:
        racecheck.deinstrument(Toy)


def test_mirror_event_handoff_clean():
    """set→wait is a publish edge: the classic flag-then-read pattern."""
    class Toy:
        GUARDED_BY = {"x": None}

        def __init__(self):
            self.x = 0

    racecheck.instrument(Toy)
    try:
        with racecheck.arm() as rc:
            toy = Toy()
            ev = threading.Event()
            out = []

            def w():
                toy.x = 9
                ev.set()

            def r():
                ev.wait()
                out.append(toy.x)

            run2(w, r)
        assert codes(rc) == [], codes(rc)
        assert out == [9]
    finally:
        racecheck.deinstrument(Toy)


def test_mirror_join_orders_teardown_read():
    """start/join edges: single-threaded setup, a worker's stores, and
    the parent's post-join read are all ordered — no lock needed."""
    class Toy:
        GUARDED_BY = {"x": "lock"}

        def __init__(self):
            self.lock = locking.make_lock("leaf:lru")
            self.x = 0

    racecheck.instrument(Toy)
    try:
        with racecheck.arm() as rc:
            toy = Toy()
            toy.x = 1                       # pre-start setup, no guard

            def w():
                with toy.lock:
                    toy.x += 1

            t = threading.Thread(target=w)
            t.start()
            t.join()
            assert toy.x == 2               # post-join stats read, no guard
        assert codes(rc) == [], codes(rc)
    finally:
        racecheck.deinstrument(Toy)


# ------------------------------------------------ real paths: no false pos


POL = Policy(entry_size=4096 + 32, log_entries=256, page_size=4096,
             read_cache_pages=8, batch_min=8, batch_max=64)


def test_real_multiwriter_engine_clean():
    """A compact slice of the 8-writer stress under an armed detector:
    disjoint writers, readers, stats() aggregation mid-flight, then the
    post-shutdown stats read — all against the annotated contract."""
    with racecheck.arm() as rc:
        nv = NVCache(POL, Tier(DRAM))
        fd = nv.open("/f")
        N, SZ = 4, 4096

        def worker(i):
            for _ in range(10):
                nv.pwrite(fd, bytes([i + 1]) * SZ, i * SZ)
                nv.pread(fd, SZ, i * SZ)

        def watcher():
            for _ in range(5):
                nv.stats()

        run2(*[lambda i=i: worker(i) for i in range(N)], watcher)
        for i in range(N):
            assert nv.pread(fd, SZ, i * SZ) == bytes([i + 1]) * SZ
        nv.fsync(fd)
        nv.close(fd)
        nv.shutdown()
        nv.stats()
    assert codes(rc) == [], "\n".join(str(v) for v in rc.violations)


def test_real_stats_snapshot_not_torn():
    """Satellite regression for the stats() race: hammer one byte range
    from two writers while a third thread aggregates stats().  The old
    unlocked `lru.stats_hits += 1` / bare-field aggregation pattern is
    planted as a mirror below; the real path must stay silent."""
    with racecheck.arm() as rc:
        nv = NVCache(POL, Tier(DRAM))
        fd = nv.open("/f")
        stop = threading.Event()

        def writer(pat):
            while not stop.is_set():
                nv.pwrite(fd, bytes([pat]) * 4096, 0)

        def aggregator():
            for _ in range(30):
                s = nv.stats()
                assert s["lru_hits"] >= 0
            stop.set()

        run2(lambda: writer(0xAA), lambda: writer(0xBB), aggregator)
        nv.close(fd)
        nv.shutdown()
    assert codes(rc) == [], "\n".join(str(v) for v in rc.violations)


def test_planted_unlocked_counter_aggregation_rc():
    """The failing-before shape of the stats() bug this PR fixes: two
    writer threads bump a shared counter under *different* page locks
    (mutual exclusion in neither pair), a reader aggregates it bare.
    The detector must call it — this is the lost-update torn read
    api.stats() used to be able to return."""
    class Stats:
        GUARDED_BY = {"hits": "lock"}

        def __init__(self):
            self.lock = locking.make_lock("leaf:lru")
            self.hits = 0

    racecheck.instrument(Stats)
    try:
        with racecheck.arm() as rc:
            st = Stats()
            page_a = locking.make_lock("page_atomic", order_key=0)
            page_b = locking.make_lock("page_atomic", order_key=1)
            gate = threading.Semaphore(0)
            end = threading.Barrier(2)

            def hit_a():
                with page_a:
                    st.hits += 1    # wrong lock: the old api.py pattern
                gate.release()
                end.wait()

            def hit_b():
                gate.acquire()
                with page_b:
                    st.hits += 1
                end.wait()

            run2(hit_a, hit_b)
        got = set(codes(rc))
        assert {"RC001", "RC003"} & got, codes(rc)
    finally:
        racecheck.deinstrument(Stats)


# ------------------------------------------------------- planted: static


HIERARCHY = lint.parse_hierarchy()


def lint_snippet(tmp_path: Path, src: str):
    p = tmp_path / "snippet.py"
    p.write_text(src)
    return lint.lint_file(p, ast.parse(src), HIERARCHY, set())


def test_lint_l004_guard_dropped(tmp_path):
    out = lint_snippet(tmp_path, (
        "class C:\n"
        "    GUARDED_BY = {'x': '_lock'}\n"
        "    def bump(self):\n"
        "        self.x += 1\n"
    ))
    assert [f.code for f in out] == ["L004"]


def test_lint_l004_write_spec_and_suppression(tmp_path):
    out = lint_snippet(tmp_path, (
        "class C:\n"
        "    GUARDED_BY = {'x': 'write:_lock'}\n"
        "    def read_ok(self):\n"
        "        return self.x\n"          # write: spec — reads are free
        "    def write_bad(self):\n"
        "        self.x = 1\n"
        "    def write_hushed(self):\n"
        "        self.x = 2  # lint: allow(L004)\n"
    ))
    assert [f.code for f in out] == ["L004"]
    assert "write_bad" not in out[0].msg   # message names class.field
    assert out[0].line == 6


def test_lint_l004_clean_mirrors(tmp_path):
    out = lint_snippet(tmp_path, (
        "class C:\n"
        "    GUARDED_BY = {'x': '_lock'}\n"
        "    def bump(self):\n"
        "        with self._lock:\n"
        "            self.x += 1\n"
        "    def bump_locked(self):\n"     # *_locked: caller holds it
        "        self.x += 1\n"
        "    def __init__(self):\n"
        "        self.x = 0\n"
    ))
    assert out == []


def test_lint_l005_undeclared_public_attr(tmp_path):
    out = lint_snippet(tmp_path, (
        "from repro_torch.core import locking\n"
        "class D:\n"
        "    def __init__(self):\n"
        "        self.lock = locking.make_lock('leaf:lru')\n"
        "        self.n = 0\n"
        "    def bump(self):\n"
        "        self.n += 1\n"
    ))
    assert "L005" in [f.code for f in out]


def test_lint_l005_clean_when_declared(tmp_path):
    out = lint_snippet(tmp_path, (
        "from repro_torch.core import locking\n"
        "class D:\n"
        "    GUARDED_BY = {'n': 'lock'}\n"
        "    def __init__(self):\n"
        "        self.lock = locking.make_lock('leaf:lru')\n"
        "        self.n = 0\n"
        "    def bump(self):\n"
        "        with self.lock:\n"
        "            self.n += 1\n"
    ))
    assert out == []
