"""The twin of ``tests/test_pmcheck_planted.py`` on the port's engine copy
(``repro_torch``), the same cases against the same bars.

Planted-bug suite for the persistence-ordering sanitizer (repro_torch.analysis).

Two halves, one acceptance bar each:

* **zero false positives** — every REAL commit protocol in the engine
  (log group commit, frame flip, route record, consume/retire) runs clean
  under an attached :class:`~repro_torch.analysis.pmcheck.PMCheck`;
* **zero false negatives** — deterministic mutations of those protocols
  (one pwb dropped, a fence reordered, a store slipped into the commit
  window, the commit flush omitted) each trip exactly the expected error
  code.

The planted sequences mirror ``LogShard.append`` / ``PagedRegion
.frame_write`` / ``EpochRouter._persist_locked`` byte-for-byte, minus the
one mutation under test, so a future protocol change that breaks the
mirror shows up as a planted test failing to plant (asserting the code
fired catches that too).
"""
import struct
import threading
import zlib

import pytest

from repro_torch.analysis import pmcheck
from repro_torch.core import Policy
from repro_torch.core.log import CG_FREE, CG_HEAD, HDR_SIZE, NVLog, _HDR
from repro_torch.core.nvmm import NVMM
from repro_torch.core.pager import FR_MAPPED, PagedRegion, _FR
from repro_torch.core.policy import CACHELINE, FRAME_HDR, ROUTE_HDR
from repro_torch.core.router import EpochRouter, _RT_ENT, _RT_HDR
from _torch_engine import full_scan_guard  # noqa: F401


def mk(frames: int = 0):
    pol = Policy(entry_size=256, log_entries=64, page_size=256,
                 read_cache_pages=4, batch_min=1, batch_max=8,
                 page_frames=frames)
    nvmm = NVMM(pol.nvmm_bytes, track=True)
    log = NVLog(nvmm, pol)                    # formats the region
    pm = pmcheck.attach(nvmm, pol)            # shadow starts all-durable
    return nvmm, pol, log, pm


def codes(pm):
    return [v.code for v in pm.violations]


# ---------------------------------------------------------------- real paths


def test_real_log_append_single_and_group_clean():
    nvmm, pol, log, pm = mk()
    log.append(1, 0, b"x" * 16)                      # single entry
    log.append(1, 0, b"y" * (pol.entry_data * 3))    # head + 2 followers
    assert codes(pm) == []
    assert pm.stats_commits == 2


def test_real_consume_clean():
    nvmm, pol, log, pm = mk()
    for i in range(4):
        log.append(1, i * 8, bytes([i]) * 8)
    log.shards[0].consume(0, 4)
    assert codes(pm) == []


def test_real_frame_flip_clean():
    nvmm, pol, log, pm = mk(frames=4)
    pager = PagedRegion(nvmm, pol, log.next_seq)
    idx = pager.alloc(1, 0)
    pager.frame_write(idx, 1, 0, 0, 64, b"a" * 64, b"", 0)    # fresh frame
    pager.frame_write(idx, 1, 0, 32, 96, b"b" * 64, None, 0)  # slot flip
    pager.truncate_frame(idx, 48)
    pager.invalidate([idx])
    assert codes(pm) == []
    assert pm.stats_commits == 3          # truncate reseals, invalidate frees


def test_real_route_record_clean():
    nvmm, pol, log, pm = mk()
    router = EpochRouter(nvmm, pol, sampling=False)
    assert router.install(3, 0)
    assert codes(pm) == []
    assert pm.stats_commits == 1


# ------------------------------------------------------------- planted: log


def plant_group(nvmm, pol, *, skip_follower_pwb=False, skip_fence=False,
                pwb_after_fence=False, skip_commit_pwb=False,
                store_mid=False, double_pwb=False):
    """Mirror of ``LogShard.append`` for a 2-entry group at slots 0/1 with
    exactly one mutation enabled."""
    base = pol.shard_base(0)
    data0, data1 = b"h" * 32, b"f" * 32

    def fill(slot, cg, data):
        eoff = base + slot * pol.entry_size
        crc = zlib.crc32(data)
        nvmm.store(eoff, _HDR.pack(cg, 7, slot * 32, 1, len(data), 0, crc))
        nvmm.store(eoff + HDR_SIZE, data)
        return eoff

    e1 = fill(1, 2, data1)                      # follower (cg = head + 2)
    if not skip_follower_pwb and not pwb_after_fence:
        nvmm.pwb(e1, HDR_SIZE + len(data1))
    e0 = fill(0, CG_FREE, data0)                # head, uncommitted
    nvmm.store(e0 + 32, struct.pack("<I", 1))   # patch nfollow
    nvmm.pwb(e0, HDR_SIZE + len(data0))
    if double_pwb:
        nvmm.pwb(e0, HDR_SIZE + len(data0))     # covers no new dirty line
    if not skip_fence:
        nvmm.pfence()
    if pwb_after_fence:
        nvmm.pwb(e1, HDR_SIZE + len(data1))     # too late: nothing fences it
    nvmm.store_u64(e0, CG_HEAD)                 # commit the group
    if store_mid:
        nvmm.store(e1 + HDR_SIZE, b"Z" * 8)     # rides the open commit
    if not skip_commit_pwb:
        nvmm.pwb(e0, 8)
    nvmm.psync()


def test_planted_log_control_is_clean():
    nvmm, pol, log, pm = mk()
    plant_group(nvmm, pol)
    assert codes(pm) == []
    assert pm.stats_commits == 1


def test_planted_missing_follower_pwb_is_pm001():
    nvmm, pol, log, pm = mk()
    plant_group(nvmm, pol, skip_follower_pwb=True)
    assert codes(pm) == ["PM001"]


def test_planted_missing_fence_is_pm001():
    nvmm, pol, log, pm = mk()
    plant_group(nvmm, pol, skip_fence=True)
    assert codes(pm) == ["PM001"]


def test_planted_pwb_reordered_after_fence_is_pm001():
    nvmm, pol, log, pm = mk()
    plant_group(nvmm, pol, pwb_after_fence=True)
    assert codes(pm) == ["PM001"]


def test_planted_store_inside_commit_window_is_pm002():
    nvmm, pol, log, pm = mk()
    plant_group(nvmm, pol, store_mid=True)
    assert codes(pm) == ["PM002"]


def test_planted_missing_commit_pwb_is_pm004():
    nvmm, pol, log, pm = mk()
    plant_group(nvmm, pol, skip_commit_pwb=True)
    assert codes(pm) == ["PM004"]


def test_planted_redundant_pwb_is_diagnostic_not_error():
    nvmm, pol, log, pm = mk()
    plant_group(nvmm, pol, double_pwb=True)
    assert codes(pm) == []
    assert pm.diag_redundant_pwb == 1
    nvmm.pfence()                               # nothing requested: empty
    assert pm.diag_empty_fence == 1


# ----------------------------------------------------------- planted: frame


def plant_frame(nvmm, pol, *, skip_image_pwb=False, skip_fence=False):
    fb = pol.frame_base(0)
    img = b"q" * 96
    doff = fb + FRAME_HDR
    nvmm.store(doff, img)
    if not skip_image_pwb:
        nvmm.pwb(doff, len(img))
    if not skip_fence:
        nvmm.pfence()
    nvmm.store(fb, _FR.pack(FR_MAPPED, 0, 5, 9, 1, len(img),
                            zlib.crc32(img)))
    nvmm.pwb(fb, _FR.size)
    nvmm.psync()


def test_planted_frame_control_is_clean():
    nvmm, pol, log, pm = mk(frames=4)
    plant_frame(nvmm, pol)
    assert codes(pm) == []
    assert pm.stats_commits == 1


def test_planted_frame_missing_image_pwb_is_pm001():
    nvmm, pol, log, pm = mk(frames=4)
    plant_frame(nvmm, pol, skip_image_pwb=True)
    assert codes(pm) == ["PM001"]


def test_planted_frame_missing_fence_is_pm001():
    nvmm, pol, log, pm = mk(frames=4)
    plant_frame(nvmm, pol, skip_fence=True)
    assert codes(pm) == ["PM001"]


# ----------------------------------------------------------- planted: route


def plant_route(nvmm, pol, *, skip_fence=False):
    base = pol.route_base
    payload = _RT_ENT.pack(3, 0)
    nvmm.store(base + ROUTE_HDR, payload)
    nvmm.pwb(base + ROUTE_HDR, len(payload))
    if not skip_fence:
        nvmm.pfence()
    crc = zlib.crc32(payload + struct.pack("<QI", 1, 1))
    nvmm.store(base, _RT_HDR.pack(1, 1, crc))
    nvmm.pwb(base, ROUTE_HDR)
    nvmm.psync()


def test_planted_route_control_is_clean():
    nvmm, pol, log, pm = mk()
    plant_route(nvmm, pol)
    assert codes(pm) == []
    assert pm.stats_commits == 1


def test_planted_route_missing_fence_is_pm001():
    nvmm, pol, log, pm = mk()
    plant_route(nvmm, pol, skip_fence=True)
    assert codes(pm) == ["PM001"]


# -------------------------------------------------------------- suppression


def test_allow_set_suppresses_code():
    pol = Policy(entry_size=256, log_entries=64, page_size=256,
                 read_cache_pages=4)
    nvmm = NVMM(pol.nvmm_bytes, track=True)
    NVLog(nvmm, pol)
    pm = pmcheck.attach(nvmm, pol, allow={"PM001"})
    plant_group(nvmm, pol, skip_fence=True)
    assert codes(pm) == []


def test_crash_discards_open_windows():
    nvmm, pol, log, pm = mk()
    base = pol.shard_base(0)
    nvmm.store(base + HDR_SIZE, b"p" * 16)       # dirty, unfenced payload
    nvmm.crash()                                  # power loss mid-protocol
    plant_group(nvmm, pol)                        # fresh protocol run: clean
    assert codes(pm) == []


# ------------------------------------------------- NVMM fence/pwb race (core)


def test_drain_requested_survives_concurrent_pwb():
    """Regression: ``NVMM._drain_requested`` iterated ``_requested`` while
    a concurrent ``pwb`` mutated it ("Set changed size during iteration"
    out of the crash-fuse sweeps under --sanitize).  A fence over a long
    requested set racing a store+pwb loop killed the old code within a
    handful of reps at a short switch interval."""
    import sys
    nvmm = NVMM(1024 * CACHELINE, track=True)
    stop = threading.Event()
    errors = []

    def writer():
        i = 0
        try:
            while not stop.is_set():
                off = (i % 1000) * CACHELINE
                nvmm.store(off, b"w" * 8)
                nvmm.pwb(off, 8)
                i += 1
        except RuntimeError as e:          # pragma: no cover - pre-fix path
            errors.append(e)
            stop.set()

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    t = threading.Thread(target=writer)
    t.start()
    try:
        for _ in range(60):
            if stop.is_set():
                break
            for j in range(200):
                nvmm.store(j * CACHELINE, b"m" * 8)
                nvmm.pwb(j * CACHELINE, 8)
            nvmm.psync()
    except RuntimeError as e:              # pragma: no cover - pre-fix path
        errors.append(e)
    finally:
        stop.set()
        t.join()
        sys.setswitchinterval(prev)
    assert not errors
