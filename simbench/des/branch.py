"""Branch predictors: bimodal (default), large bi-mode, and TAGE-lite —
the design-space alternatives exercised in the paper's §5 use case."""
from __future__ import annotations

import numpy as np


class Bimodal:
    def __init__(self, bits: int = 12):
        self.table = np.full(1 << bits, 2, np.int8)  # 2-bit counters, weakly taken
        self.mask = (1 << bits) - 1

    def reset(self):
        self.table.fill(2)

    def predict(self, pc: int) -> bool:
        return bool(self.table[(pc >> 2) & self.mask] >= 2)

    def update(self, pc: int, taken: bool):
        i = (pc >> 2) & self.mask
        if taken:
            self.table[i] = min(self.table[i] + 1, 3)
        else:
            self.table[i] = max(self.table[i] - 1, 0)


class BiMode:
    """Bi-mode: choice table selects between taken/not-taken biased tables."""

    def __init__(self, bits: int = 13):
        self.choice = np.full(1 << bits, 2, np.int8)
        self.taken_t = np.full(1 << bits, 2, np.int8)
        self.not_t = np.full(1 << bits, 1, np.int8)
        self.mask = (1 << bits) - 1
        self.ghist = 0

    def reset(self):
        self.choice.fill(2)
        self.taken_t.fill(2)
        self.not_t.fill(1)
        self.ghist = 0

    def _idx(self, pc):
        return ((pc >> 2) ^ self.ghist) & self.mask

    def predict(self, pc: int) -> bool:
        i = self._idx(pc)
        c = (pc >> 2) & self.mask
        table = self.taken_t if self.choice[c] >= 2 else self.not_t
        return bool(table[i] >= 2)

    def update(self, pc: int, taken: bool):
        i = self._idx(pc)
        c = (pc >> 2) & self.mask
        use_taken = self.choice[c] >= 2
        table = self.taken_t if use_taken else self.not_t
        pred = table[i] >= 2
        if taken:
            table[i] = min(table[i] + 1, 3)
        else:
            table[i] = max(table[i] - 1, 0)
        if pred != taken or (pred == taken and (table[i] >= 2) == use_taken):
            if taken:
                self.choice[c] = min(self.choice[c] + 1, 3)
            else:
                self.choice[c] = max(self.choice[c] - 1, 0)
        self.ghist = ((self.ghist << 1) | int(taken)) & self.mask


class TageLite:
    """Small TAGE: base bimodal + 4 tagged tables, geometric histories."""

    def __init__(self, bits: int = 11, hist_lengths=(4, 16, 44, 130)):
        self.base = Bimodal(bits)
        self.n = len(hist_lengths)
        self.hist_lengths = hist_lengths
        size = 1 << bits
        self.ctr = [np.zeros(size, np.int8) for _ in range(self.n)]
        self.tag = [np.full(size, -1, np.int32) for _ in range(self.n)]
        self.useful = [np.zeros(size, np.int8) for _ in range(self.n)]
        self.mask = size - 1
        self.ghist = np.zeros(256, np.int8)

    def reset(self):
        self.base.reset()
        for t in range(self.n):
            self.ctr[t].fill(0)
            self.tag[t].fill(-1)
            self.useful[t].fill(0)
        self.ghist.fill(0)

    def _fold(self, length: int) -> int:
        h = 0
        for i in range(length):
            h = ((h << 1) | int(self.ghist[i])) & 0xFFFFFF
        return h

    def _index_tag(self, pc, t):
        h = self._fold(self.hist_lengths[t])
        idx = ((pc >> 2) ^ h ^ (h >> 7)) & self.mask
        tg = ((pc >> 2) ^ (h >> 3)) & 0xFFF
        return idx, tg

    def predict(self, pc: int) -> bool:
        pred = self.base.predict(pc)
        for t in range(self.n):
            idx, tg = self._index_tag(pc, t)
            if self.tag[t][idx] == tg:
                pred = self.ctr[t][idx] >= 0
        return bool(pred)

    def update(self, pc: int, taken: bool):
        provider = -1
        pidx = 0
        for t in range(self.n):
            idx, tg = self._index_tag(pc, t)
            if self.tag[t][idx] == tg:
                provider, pidx = t, idx
        if provider >= 0:
            c = self.ctr[provider][pidx]
            self.ctr[provider][pidx] = np.clip(c + (1 if taken else -1), -4, 3)
        else:
            self.base.update(pc, taken)
            # allocate in a random-ish higher table
            t = (pc >> 2) % self.n
            idx, tg = self._index_tag(pc, t)
            if self.useful[t][idx] == 0:
                self.tag[t][idx] = tg
                self.ctr[t][idx] = 0 if taken else -1
        self.ghist = np.roll(self.ghist, 1)
        self.ghist[0] = int(taken)


PREDICTORS = {"bimodal": Bimodal, "bimode": BiMode, "tage": TageLite}


def make_predictor(name: str, **kw):
    return PREDICTORS[name](**kw)
