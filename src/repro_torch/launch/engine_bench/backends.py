"""The seven evaluated storage stacks (paper Table IV), as FS factories.

Device-time scale: simulated device costs are multiplied by SCALE so that
the Python interpreter overhead of the NVCache hot path (~tens of µs per
op, standing in for the paper's ~µs Optane path) keeps the same *ratio* to
the modeled SSD/NVMM costs as on the paper's hardware.  Ratios between
stacks are the experiment; absolute MiB/s are scaled.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import NVCache, Policy
from repro_torch.storage import tiers
from repro_torch.storage.fsapi import NVCacheFS, TierFS

SCALE = 20.0

EXT4_DAX = dataclasses.replace(tiers.NVMM_OPTANE, name="ext4dax",
                               page_write_s=2.4e-6, page_read_s=1.5e-6,
                               syscall_s=3e-6)
NOVA = dataclasses.replace(tiers.NVMM_OPTANE, name="nova",
                           page_write_s=1.9e-6, page_read_s=1.3e-6,
                           syscall_s=2e-6)


def policy(log_mib: float, *, entry=4096, batch_min=1000, batch_max=10000,
           read_pages=1024, shards=1, shard_route="stripe",
           drain_coalesce=True, fsync_epoch=True, readahead=8,
           span_batches=True, deadline_ms=5.0, rebalance=False,
           rebalance_epoch_ms=50.0, placement_groups=1,
           page_frames=0, classify_window=32, obs_level=0) -> Policy:
    return Policy(entry_size=entry, log_entries=max(8 * shards, int(log_mib * 1024 * 1024 // entry)),
                  page_size=4096, read_cache_pages=read_pages,
                  batch_min=batch_min, batch_max=batch_max, verify_crc=False,
                  shards=shards, shard_route=shard_route,
                  drain_coalesce=drain_coalesce, fsync_epoch=fsync_epoch,
                  readahead_pages=readahead,
                  coalesce_span_batches=span_batches,
                  coalesce_deadline_ms=deadline_ms,
                  shard_rebalance=rebalance,
                  rebalance_epoch_ms=rebalance_epoch_ms,
                  placement_groups=placement_groups,
                  page_frames=page_frames, classify_window=classify_window,
                  obs_level=obs_level)


@dataclasses.dataclass
class Stack:
    name: str
    fs: object
    nv: object = None       # NVCache instance when applicable
    tier: object = None

    def close(self):
        if self.nv is not None:
            try:
                self.nv.shutdown()
            except Exception:
                pass


def make_stack(name: str, *, log_mib: float = 64, batch_min=1000,
               batch_max=10000, read_pages=1024, scale: float = SCALE,
               shards: int = 1, shard_route: str = "stripe",
               drain_coalesce: bool = True, fsync_epoch: bool = True,
               readahead: int = 8, span_batches: bool = True,
               deadline_ms: float = 5.0, rebalance: bool = False,
               rebalance_epoch_ms: float = 50.0,
               placement_groups: int = 1, page_frames: int = 0,
               classify_window: int = 32, obs_level: int = 0) -> Stack:
    if name == "nvcache+ssd":
        tier = tiers.Tier(tiers.SSD_SATA, sync=False, scale=scale)
        nv = NVCache(policy(log_mib, batch_min=batch_min, batch_max=batch_max,
                            read_pages=read_pages, shards=shards,
                            shard_route=shard_route,
                            drain_coalesce=drain_coalesce,
                            fsync_epoch=fsync_epoch, readahead=readahead,
                            span_batches=span_batches,
                            deadline_ms=deadline_ms, rebalance=rebalance,
                            rebalance_epoch_ms=rebalance_epoch_ms,
                            placement_groups=placement_groups,
                            page_frames=page_frames,
                            classify_window=classify_window,
                            obs_level=obs_level), tier)
        return Stack(name, NVCacheFS(nv), nv, tier)
    if name == "nvcache+nova":
        tier = tiers.Tier(NOVA, sync=False, scale=scale)
        nv = NVCache(policy(log_mib, batch_min=batch_min, batch_max=batch_max,
                            read_pages=read_pages, shards=shards,
                            shard_route=shard_route,
                            drain_coalesce=drain_coalesce,
                            fsync_epoch=fsync_epoch, readahead=readahead,
                            span_batches=span_batches,
                            deadline_ms=deadline_ms, rebalance=rebalance,
                            rebalance_epoch_ms=rebalance_epoch_ms,
                            placement_groups=placement_groups,
                            page_frames=page_frames,
                            classify_window=classify_window,
                            obs_level=obs_level), tier)
        return Stack(name, NVCacheFS(nv), nv, tier)
    if name == "dm-writecache":
        tier = tiers.DMWriteCacheTier(scale=scale)
        return Stack(name, TierFS(tier), tier=tier)
    if name == "ssd":
        tier = tiers.Tier(tiers.SSD_SATA, sync=True, scale=scale)
        return Stack(name, TierFS(tier), tier=tier)
    if name == "ext4-dax":
        tier = tiers.Tier(EXT4_DAX, sync=True, scale=scale)
        return Stack(name, TierFS(tier), tier=tier)
    if name == "nova":
        tier = tiers.Tier(NOVA, sync=True, scale=scale)
        return Stack(name, TierFS(tier), tier=tier)
    if name == "tmpfs":
        tier = tiers.Tier(tiers.DRAM, volatile=True, scale=scale)
        return Stack(name, TierFS(tier), tier=tier)
    raise KeyError(name)


ALL_STACKS = ["nvcache+ssd", "dm-writecache", "ext4-dax", "nova", "ssd",
              "tmpfs", "nvcache+nova"]
