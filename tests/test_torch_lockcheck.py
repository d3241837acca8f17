"""The twin of ``tests/test_lockcheck.py`` on the port's engine copy
(``repro_torch``), the same cases against the same bars.

Unit tests for the lock-hierarchy tracer and the static lint pass
(repro_torch.analysis.lockcheck / repro_torch.analysis.lint) plus the hierarchy table
itself (repro_torch.core.locking)."""
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import lint
from repro_torch.analysis.lockcheck import LockTracer
from repro_torch.core import locking
from repro_torch.core.locking import HIERARCHY, LEAF_LEVEL, parse_hierarchy
from _torch_engine import full_scan_guard  # noqa: F401


# ------------------------------------------------------------- the hierarchy


def test_hierarchy_table_parses_and_is_sane():
    h = parse_hierarchy()
    assert h == HIERARCHY
    for name in ("meta", "route_gate", "page_atomic", "page_cleanup",
                 "shard", "pager_free"):
        assert name in h, name
    # ordered classes sit strictly below the leaf band
    ordered = {n: i for n, i in h.items() if not n.startswith("leaf:")}
    assert all(i["level"] < LEAF_LEVEL for i in ordered.values())
    assert all(i["level"] == LEAF_LEVEL for n, i in h.items()
               if n.startswith("leaf:"))
    # the write path holds page locks across log.append: shard ranks after
    assert h["page_atomic"]["level"] < h["shard"]["level"]
    assert h["page_atomic"]["multi"] and h["page_cleanup"]["multi"]


# ---------------------------------------------------------------- the tracer


def lk(tracer, name, **kw):
    return tracer.traced_lock(name, HIERARCHY[name], **kw)


def test_lc001_on_level_inversion():
    tr = LockTracer()
    meta, shard = lk(tr, "meta"), lk(tr, "shard")
    with shard:
        with meta:                      # 50 -> 10: inversion
            pass
    assert any(v.code == "LC001" for v in tr.violations)


def test_in_order_acquire_is_clean_and_recorded():
    tr = LockTracer()
    meta, shard = lk(tr, "meta"), lk(tr, "shard")
    with meta:
        with shard:
            pass
    assert tr.violations == []
    assert ("meta", "shard") in tr.edges


def test_lc002_on_descending_multi_keys():
    tr = LockTracer()
    p3 = lk(tr, "page_atomic", order_key=3)
    p1 = lk(tr, "page_atomic", order_key=1)
    with p3:
        with p1:                        # same class, key 1 after 3
            pass
    assert any(v.code == "LC002" for v in tr.violations)
    tr2 = LockTracer()
    a, b = lk(tr2, "page_atomic", order_key=1), lk(tr2, "page_atomic",
                                                   order_key=2)
    with a:
        with b:                         # ascending: fine
            pass
    assert tr2.violations == []


def test_trylock_is_exempt_from_ordering():
    tr = LockTracer()
    meta, shard = lk(tr, "meta"), lk(tr, "shard")
    with shard:
        assert meta.acquire(blocking=False)   # try-lock: cannot deadlock
        meta.release()
    assert tr.violations == []


def test_lc004_backend_io_under_shard_lock():
    tr = LockTracer()
    shard = lk(tr, "shard")
    with shard:
        tr.on_backend_io("pwritev", "/f")
    assert any(v.code == "LC004" for v in tr.violations)
    tr.violations.clear()
    tr.on_backend_io("fsync", "/f")           # not held: fine
    assert tr.violations == []


def test_lc003_cycle_detection():
    tr = LockTracer()
    tr.edges[("a", "b")] = "t1"
    tr.edges[("b", "c")] = "t1"
    tr.edges[("c", "a")] = "t2"
    assert tr.check_cycles()
    assert any(v.code == "LC003" for v in tr.violations)
    tr2 = LockTracer()
    tr2.edges[("a", "b")] = "t1"
    tr2.edges[("a", "c")] = "t1"
    assert tr2.check_cycles() == []


def test_traced_condition_notify_while_held():
    """Regression: TracedLock lacked ``_is_owned``, so Condition's fallback
    probe (``acquire(False)``) succeeded reentrantly on RLock-backed
    wrappers and ``notify`` raised "cannot notify on un-acquired lock"."""
    tr = LockTracer()
    prev = locking._tracer              # --sanitize arms a session tracer:
    locking.set_tracer(tr)              # restore IT, not None, or every
    try:                                # later test loses its lock edges
        cv = locking.make_condition("leaf:fsync_epoch")
        with cv:
            cv.notify_all()             # raised before the fix
            assert cv._lock._is_owned()
        # release/acquire cycles used by Condition.wait keep the owner sane
        shared = locking.make_lock("shard")
        cv2 = locking.make_condition("shard", shared)
        with cv2:
            state = shared._release_save()
            assert not shared._is_owned()
            shared._acquire_restore(state)
            assert shared._is_owned()
    finally:
        locking.set_tracer(prev)
    assert tr.violations == []


def test_untraced_factories_return_plain_locks():
    prev = locking._tracer
    locking.set_tracer(None)
    try:
        lock = locking.make_lock("shard")
        assert type(lock).__module__ == "_thread"   # zero overhead when off
    finally:
        locking.set_tracer(prev)


# ------------------------------------------------------------------ the lint


@pytest.mark.parametrize("package", ["core", "obs"])
def test_lint_clean_on_the_port_s_tree(package):
    """0 findings on the port's ``core`` and ``obs`` (``lint.main``'s
    default paths): the shipped annotations satisfy every rule, L004/L005
    too.  ``tests/test_lockcheck.py::test_lint_clean_on_core`` and
    ``tests/test_racecheck_planted.py::test_lint_real_core_tree_clean``
    lint ``repro.core``; the second case here takes the place of the
    latter, whose codes the first case covers."""
    import importlib
    pkg = importlib.import_module(f"repro_torch.{package}")
    assert lint.run([Path(pkg.__file__).parent]) == []


def run_lint_snippet(tmp_path, src):
    f = tmp_path / "snippet.py"
    f.write_text(textwrap.dedent(src))
    return [(x.code, x.line) for x in lint.run([f])]


def test_lint_l001_direct_construction(tmp_path):
    out = run_lint_snippet(tmp_path, """\
        import threading
        lock = threading.Lock()
        """)
    assert ("L001", 2) in out


def test_lint_l001_unknown_class_and_non_literal(tmp_path):
    out = run_lint_snippet(tmp_path, """\
        from repro_torch.core import locking
        a = locking.make_lock("no_such_class")
        name = "shard"
        b = locking.make_lock(name)
        """)
    assert ("L001", 2) in out and ("L001", 4) in out


def test_lint_l002_io_under_shard_lock(tmp_path):
    out = run_lint_snippet(tmp_path, """\
        from repro_torch.core import locking
        import time

        class S:
            def __init__(self):
                self._lock = locking.make_lock("shard")

            def bad(self, backend, data):
                with self._lock:
                    time.sleep(0.1)
                    backend.pwritev(data, 0)

            def good(self, backend, data):
                with self._lock:
                    pass
                backend.pwritev(data, 0)
        """)
    codes = [c for c, _ in out]
    assert codes.count("L002") == 2
    assert ("L002", 10) in out and ("L002", 11) in out


def test_lint_l003_psync_without_pwb(tmp_path):
    out = run_lint_snippet(tmp_path, """\
        def bad(nvmm, off, data):
            nvmm.store(off, data)
            nvmm.psync()

        def good(nvmm, off, data):
            nvmm.store(off, data)
            nvmm.pwb(off, len(data))
            nvmm.psync()
        """)
    assert out == [("L003", 3)]


def test_lint_suppression_comment(tmp_path):
    out = run_lint_snippet(tmp_path, """\
        def odd(nvmm):
            nvmm.psync()  # lint: allow(L003)
        """)
    assert out == []
