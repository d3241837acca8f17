"""NVCache core — the paper's contribution (user-space NVMM write-back
cache with synchronous durability and durable linearizability)."""
from repro_torch.core.api import NVCache, O_APPEND, O_CREAT, O_RDONLY, O_RDWR, O_TRUNC, O_WRONLY
from repro_torch.core.log import EntryRef, NVLog
from repro_torch.core.namespace import Namespace
from repro_torch.core.nvmm import NVMM
from repro_torch.core.policy import PAPER_DEFAULT, TEST_SMALL, Policy
from repro_torch.core.recovery import RecoveryStats, recover
from repro_torch.core.router import EpochRouter

__all__ = [
    "NVCache", "NVLog", "NVMM", "Namespace", "EntryRef", "EpochRouter",
    "Policy", "PAPER_DEFAULT", "TEST_SMALL", "RecoveryStats", "recover",
    "O_RDONLY", "O_WRONLY", "O_RDWR", "O_CREAT", "O_APPEND", "O_TRUNC",
]
