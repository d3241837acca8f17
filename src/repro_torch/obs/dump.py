"""Flight-recorder forensic dump — ``python -m repro.obs.dump``.

Two modes:

* ``python -m repro.obs.dump <image.bin> [--policy test|paper]`` —
  decode the flight ring out of a raw NVMM image (the byte dump of a
  region, e.g. ``bytes(nvmm.load(0, nvmm.size))`` written to a file)
  and print the surviving timeline.  The policy choice must match the
  image's geometry — the superblock is validated first and a mismatch
  is reported rather than mis-decoded.
* ``python -m repro.obs.dump --selftest`` — build a small engine,
  run writes/namespace ops, inject a power loss mid-workload, recover,
  and print the post-crash forensic timeline.  Exit 1 if the recovered
  timeline is empty or not seq-consistent — CI runs this as the flight
  smoke.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core.policy import PAPER_DEFAULT, TEST_SMALL
from repro_torch.obs.flight import decode_ring, format_timeline

_POLICIES = {"test": TEST_SMALL, "paper": PAPER_DEFAULT}


class _ImageNVMM:
    """Read-only NVMM shim over a raw region byte dump."""

    def __init__(self, buf: bytes):
        self._buf = buf
        self.size = len(buf)

    def load(self, off: int, n: int) -> memoryview:
        return memoryview(self._buf)[off:off + n]

    def load_u64(self, off: int) -> int:
        import struct
        return struct.unpack_from("<Q", self._buf, off)[0]


def dump_image(path: str, policy) -> int:
    with open(path, "rb") as fh:
        buf = fh.read()
    if len(buf) < policy.nvmm_bytes:
        print(f"image is {len(buf)} bytes but the {policy!r} geometry "
              f"needs {policy.nvmm_bytes} — wrong --policy?",
              file=sys.stderr)
        return 1
    nvmm = _ImageNVMM(buf)
    from repro_torch.core.log import MAGIC
    if nvmm.load_u64(0) != MAGIC:
        print("no NVCache superblock at offset 0 — not a region image?",
              file=sys.stderr)
        return 1
    events, dropped = decode_ring(nvmm, policy)
    print(format_timeline(events, dropped))
    return 0


def selftest(verbose: bool = True) -> int:
    """Crash-inject one small engine and dump the recovered timeline."""
    import dataclasses

    from repro_torch.core import recovery
    from repro_torch.core.api import NVCache
    from repro_torch.core.nvmm import NVMM
    from repro_torch.storage.tiers import Tier

    pol = dataclasses.replace(TEST_SMALL, obs_level=1)
    nvmm = NVMM(pol.nvmm_bytes, track=True)
    tier = Tier(scale=0.0)
    nv = NVCache(pol, tier, nvmm=nvmm, recover=False)
    fd = nv.open("/flight-selftest")
    for i in range(40):
        nv.pwrite(fd, bytes([i % 251]) * 64, i * 64)
    nv.close(fd)
    nv.rename("/flight-selftest", "/flight-renamed")
    fd = nv.open("/flight-renamed")
    for i in range(8):
        nv.pwrite(fd, b"\xab" * 64, i * 64)
    # power loss: drain threads die in place, volatile NVMM lines are lost
    nv._crashed = True
    nv.cleanup.power_loss()
    nvmm.crash()
    stats = recovery.recover(nvmm, pol, tier)
    events = stats.flight_events
    if verbose:
        print(format_timeline(events, stats.flight_torn_dropped))
        print(f"recovery: replayed={stats.entries_replayed} "
              f"meta={stats.meta_ops} "
              f"torn_flight_dropped={stats.flight_torn_dropped}")
    if not events:
        print("selftest FAILED: empty flight timeline after crash",
              file=sys.stderr)
        return 1
    seqs = [e.eseq for e in events]
    if any(b <= a for a, b in zip(seqs, seqs[1:])):
        print("selftest FAILED: flight timeline not seq-consistent",
              file=sys.stderr)
        return 1
    print(f"selftest OK: {len(events)} events, "
          f"eseq {seqs[0]}..{seqs[-1]}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro.obs.dump",
        description="decode an NVMM flight-recorder ring")
    ap.add_argument("image", nargs="?", help="raw NVMM region image file")
    ap.add_argument("--policy", choices=sorted(_POLICIES), default="test",
                    help="geometry of the image (default: test)")
    ap.add_argument("--selftest", action="store_true",
                    help="crash-inject a small engine and dump its ring")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest()
    if not args.image:
        ap.error("an image file (or --selftest) is required")
    return dump_image(args.image, _POLICIES[args.policy])


if __name__ == "__main__":
    sys.exit(main())
