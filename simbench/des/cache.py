"""Set-associative LRU caches and TLBs for the DES and for the lightweight
history-context simulation (paper §2.2: table lookups only — no MSHRs or
pipeline detail; those effects are the ML model's job)."""
from __future__ import annotations

import numpy as np


class Cache:
    """Set-associative LRU cache. Tracks hits, misses, writebacks."""

    def __init__(self, size: int, assoc: int, line: int = 64, name: str = ""):
        self.line = line
        self.assoc = assoc
        self.n_sets = max(size // (line * assoc), 1)
        self.tags = np.full((self.n_sets, assoc), -1, np.int64)
        self.lru = np.zeros((self.n_sets, assoc), np.int64)  # higher = newer
        self.dirty = np.zeros((self.n_sets, assoc), bool)
        self.tick = 0
        self.name = name

    def reset(self):
        self.tags.fill(-1)
        self.lru.fill(0)
        self.dirty.fill(False)
        self.tick = 0

    def access(self, addr: int, write: bool = False):
        """Returns (hit: bool, writeback: bool)."""
        self.tick += 1
        line_addr = addr // self.line
        s = line_addr % self.n_sets
        tag = line_addr // self.n_sets
        ways = self.tags[s]
        hit_way = np.where(ways == tag)[0]
        if hit_way.size:
            w = hit_way[0]
            self.lru[s, w] = self.tick
            if write:
                self.dirty[s, w] = True
            return True, False
        # miss: fill LRU way
        w = int(np.argmin(self.lru[s]))
        writeback = bool(self.dirty[s, w]) and self.tags[s, w] >= 0
        self.tags[s, w] = tag
        self.lru[s, w] = self.tick
        self.dirty[s, w] = write
        return False, writeback


class TwoLevelTLB:
    """2-stage TLB; a miss walks page tables through up to 3 levels whose
    entries may themselves hit in a small walker cache."""

    def __init__(self, l1_entries=64, l2_entries=1024, page=4096):
        self.page = page
        self.l1 = Cache(l1_entries * 8, 8, line=8, name="tlb1")
        self.l2 = Cache(l2_entries * 8, 8, line=8, name="tlb2")
        self.walk = Cache(256 * 8, 4, line=8, name="walker")

    def reset(self):
        self.l1.reset()
        self.l2.reset()
        self.walk.reset()

    def access(self, addr: int):
        """Returns (tlb_level, walk_levels (3,) int) — 1/2 = TLB hit level,
        3 = full walk; walk_levels[i] = 1 if walk step i hit its cache."""
        vpn = addr // self.page
        walk_levels = np.zeros(3, np.int64)
        hit1, _ = self.l1.access(vpn * 8)
        if hit1:
            return 1, walk_levels
        hit2, _ = self.l2.access(vpn * 8)
        if hit2:
            return 2, walk_levels
        # page walk: 3 levels of the radix tree
        for lvl in range(3):
            key = (vpn >> (9 * (2 - lvl))) * 8 + lvl
            hit, _ = self.walk.access(key)
            walk_levels[lvl] = 1 if hit else 2  # 1 = walker-cache hit, 2 = mem
        return 3, walk_levels


class CacheHierarchy:
    """L1I + L1D + shared L2 + memory; the 'history context' component."""

    def __init__(self, cfg: dict | None = None):
        c = dict(
            l1i_size=48 * 1024, l1i_assoc=3,
            l1d_size=32 * 1024, l1d_assoc=2,
            l2_size=1024 * 1024, l2_assoc=16,
            line=64,
            l1_lat=1, l1d_lat=5, l2_lat=29, mem_lat=100,
        )
        if cfg:
            c.update(cfg)
        self.cfg = c
        self.l1i = Cache(c["l1i_size"], c["l1i_assoc"], c["line"], "l1i")
        self.l1d = Cache(c["l1d_size"], c["l1d_assoc"], c["line"], "l1d")
        self.l2 = Cache(c["l2_size"], c["l2_assoc"], c["line"], "l2")
        self.itlb = TwoLevelTLB()
        self.dtlb = TwoLevelTLB()

    def reset(self):
        for x in (self.l1i, self.l1d, self.l2, self.itlb, self.dtlb):
            x.reset()

    def fetch_access(self, pc: int):
        """(level, tw_levels(3), writebacks(2))."""
        wb = np.zeros(2, np.int64)
        tlb_lvl, tw = self.itlb.access(pc)
        hit1, _ = self.l1i.access(pc)
        if hit1:
            return 1, tw, wb
        hit2, wb2 = self.l2.access(pc)
        wb[1] = int(wb2)
        return (2 if hit2 else 3), tw, wb

    def data_access(self, addr: int, write: bool):
        """(level, tw_levels(3), writebacks(3))."""
        wb = np.zeros(3, np.int64)
        tlb_lvl, tw = self.dtlb.access(addr)
        hit1, wb1 = self.l1d.access(addr, write)
        wb[0] = int(wb1)
        if hit1:
            return 1, tw, wb
        hit2, wb2 = self.l2.access(addr, write)
        wb[1] = int(wb2)
        return (2 if hit2 else 3), tw, wb

    def level_latency(self, level: int, data: bool) -> int:
        c = self.cfg
        if level <= 1:
            return c["l1d_lat"] if data else c["l1_lat"]
        if level == 2:
            return c["l2_lat"]
        return c["mem_lat"]
