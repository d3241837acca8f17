"""The flight dump (``repro_torch.obs.dump``) against the original
(``repro.obs.dump``) on one ring.

One region image comes from a seeded run of the port's engine, driven
from one thread, at ``obs_level=1`` (``batch_min`` above the log, so the
drain runs only at the barriers that close and unlink ask for): writes,
a rename and an unlink, then a power loss with adversarial eviction.
The image is written to a file and both dumps decode it through their
CLIs with the ``test`` geometry: they print the same timeline, event for
event.  Both ``--selftest`` runs pass, and both refuse an image of the
wrong geometry the same way.  No JAX test covers ``dump.py``.
"""
import dataclasses

import numpy as np
import pytest

from repro.obs import dump as jdump
from repro_torch.core import NVCache, NVMM
from repro_torch.core.policy import TEST_SMALL
from repro_torch.obs import dump
from repro_torch.storage.tiers import DRAM, Tier
from _torch_engine import full_scan_guard  # noqa: F401


def region_image(seed: int) -> bytes:
    """The NVMM region after a crash of a seeded one-thread run."""
    rng = np.random.default_rng(seed)
    pol = dataclasses.replace(TEST_SMALL, obs_level=1, batch_min=10 ** 6, batch_max=10 ** 6)
    nvmm = NVMM(pol.nvmm_bytes, track=True)
    nv = NVCache(pol, Tier(DRAM), nvmm=nvmm, recover=False)
    fd = nv.open("/flight-a")
    for i in range(int(rng.integers(12, 24))):
        nv.pwrite(fd, rng.bytes(int(rng.integers(16, 200))), int(rng.integers(0, 4096)))
    nv.close(fd)
    nv.rename("/flight-a", "/flight-b")
    fd = nv.open("/flight-c")
    nv.pwrite(fd, b"\xab" * 64, 0)
    nv.close(fd)
    nv.unlink("/flight-c")
    nv.crash(choose_evicted=lambda lines: [l for l in lines if rng.random() < 0.5])
    return bytes(nvmm.load(0, nvmm.size))


@pytest.mark.parametrize("seed", [0, 1])
def test_both_dumps_print_the_same_timeline(seed, tmp_path, capsys):
    path = tmp_path / "region.bin"
    path.write_bytes(region_image(seed))
    assert jdump.main([str(path), "--policy", "test"]) == 0
    want = capsys.readouterr()
    assert dump.main([str(path), "--policy", "test"]) == 0
    got = capsys.readouterr()
    assert got.out == want.out and got.err == want.err == ""
    events = [line for line in got.out.splitlines() if line.startswith("#")]
    assert len(events) >= 10 and any("commit" in e for e in events), got.out


def test_both_dumps_refuse_a_short_image_alike(tmp_path, capsys):
    path = tmp_path / "region.bin"
    path.write_bytes(region_image(0))
    assert jdump.main([str(path), "--policy", "paper"]) == 1
    want = capsys.readouterr()
    assert dump.main([str(path), "--policy", "paper"]) == 1
    got = capsys.readouterr()
    assert got.err == want.err and "wrong --policy?" in got.err and got.out == ""


def test_both_selftests_pass(capsys):
    assert jdump.main(["--selftest"]) == 0
    assert "selftest OK" in capsys.readouterr().out
    assert dump.main(["--selftest"]) == 0
    assert "selftest OK" in capsys.readouterr().out
