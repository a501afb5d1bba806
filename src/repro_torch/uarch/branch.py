"""Branch predictors for the detailed simulator.

Implements the four algorithms in the paper's design space (Table 3):
Local, BiMode, Tournament, and a lightweight TAGE (TAGE_SC_L stand-in).
All predictors share the predict(pc)->bool / update(pc, taken) interface and
keep their own global-history registers where applicable.
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_predictor", "PREDICTOR_NAMES"]

PREDICTOR_NAMES = ("Local", "BiMode", "Tournament", "TAGE_SC_L")


class _Base:
    name = "base"

    def predict(self, pc: int) -> bool:  # pragma: no cover - interface
        raise NotImplementedError

    def update(self, pc: int, taken: bool) -> None:  # pragma: no cover
        raise NotImplementedError


def _ctr_update(table: np.ndarray, idx: int, taken: bool) -> None:
    """Saturating 2-bit counter update."""
    v = table[idx]
    if taken:
        if v < 3:
            table[idx] = v + 1
    else:
        if v > 0:
            table[idx] = v - 1


class LocalBP(_Base):
    """Per-PC local history -> pattern table of 2-bit counters."""

    name = "Local"

    def __init__(self, hist_bits: int = 8, entries: int = 1024):
        self.hist_bits = hist_bits
        self.hist = np.zeros(entries, dtype=np.int64)
        self.entries = entries
        self.pht = np.full(1 << hist_bits, 2, dtype=np.int8)
        self.mask = (1 << hist_bits) - 1

    def _idx(self, pc: int) -> int:
        return (pc >> 2) % self.entries

    def predict(self, pc: int) -> bool:
        h = self.hist[self._idx(pc)] & self.mask
        return self.pht[h] >= 2

    def update(self, pc: int, taken: bool) -> None:
        i = self._idx(pc)
        h = self.hist[i] & self.mask
        _ctr_update(self.pht, h, taken)
        self.hist[i] = ((self.hist[i] << 1) | int(taken)) & self.mask


class BiModeBP(_Base):
    """Bi-Mode: choice table selects between taken/not-taken biased tables."""

    name = "BiMode"

    def __init__(self, hist_bits: int = 12, entries: int = 4096):
        self.ghist = 0
        self.hist_bits = hist_bits
        self.mask = (1 << hist_bits) - 1
        self.entries = entries
        self.choice = np.full(entries, 2, dtype=np.int8)
        self.taken_t = np.full(entries, 2, dtype=np.int8)
        self.ntaken_t = np.full(entries, 1, dtype=np.int8)

    def predict(self, pc: int) -> bool:
        c = self.choice[(pc >> 2) % self.entries] >= 2
        idx = ((pc >> 2) ^ (self.ghist & self.mask)) % self.entries
        tbl = self.taken_t if c else self.ntaken_t
        return tbl[idx] >= 2

    def update(self, pc: int, taken: bool) -> None:
        cidx = (pc >> 2) % self.entries
        c = self.choice[cidx] >= 2
        idx = ((pc >> 2) ^ (self.ghist & self.mask)) % self.entries
        tbl = self.taken_t if c else self.ntaken_t
        pred = tbl[idx] >= 2
        # Bi-Mode partial update rule: direction table always updates; choice
        # updates unless the chosen table was correct while disagreeing with it.
        _ctr_update(tbl, idx, taken)
        if not (pred == taken and c != taken):
            _ctr_update(self.choice, cidx, taken)
        self.ghist = ((self.ghist << 1) | int(taken)) & self.mask


class TournamentBP(_Base):
    """Alpha 21264-style: local + gshare global, with a chooser."""

    name = "Tournament"

    def __init__(self, entries: int = 4096, hist_bits: int = 12):
        self.local = LocalBP(hist_bits=10, entries=entries)
        self.ghist = 0
        self.mask = (1 << hist_bits) - 1
        self.entries = entries
        self.gshare = np.full(entries, 2, dtype=np.int8)
        self.chooser = np.full(entries, 2, dtype=np.int8)  # >=2 -> use global

    def _gidx(self, pc: int) -> int:
        return ((pc >> 2) ^ (self.ghist & self.mask)) % self.entries

    def predict(self, pc: int) -> bool:
        use_global = self.chooser[(pc >> 2) % self.entries] >= 2
        if use_global:
            return self.gshare[self._gidx(pc)] >= 2
        return self.local.predict(pc)

    def update(self, pc: int, taken: bool) -> None:
        gpred = self.gshare[self._gidx(pc)] >= 2
        lpred = self.local.predict(pc)
        if gpred != lpred:
            _ctr_update(self.chooser, (pc >> 2) % self.entries, gpred == taken)
        _ctr_update(self.gshare, self._gidx(pc), taken)
        self.local.update(pc, taken)
        self.ghist = ((self.ghist << 1) | int(taken)) & self.mask


class TageLiteBP(_Base):
    """Lightweight TAGE: bimodal base + tagged tables at geometric histories.

    Stands in for gem5's TAGE_SC_L; same interface, much smaller tables.
    """

    name = "TAGE_SC_L"

    def __init__(self, entries: int = 2048, hist_lens=(4, 8, 16, 32)):
        self.base = np.full(entries, 2, dtype=np.int8)
        self.entries = entries
        self.hist_lens = hist_lens
        self.ghist = 0
        nt = len(hist_lens)
        self.tag = np.zeros((nt, entries), dtype=np.int32)
        self.ctr = np.full((nt, entries), 2, dtype=np.int8)
        self.useful = np.zeros((nt, entries), dtype=np.int8)

    def _fold(self, length: int) -> int:
        h = self.ghist & ((1 << length) - 1)
        f = 0
        while h:
            f ^= h & 0xFFF
            h >>= 12
        return f

    def _indices(self, pc: int):
        for t, L in enumerate(self.hist_lens):
            f = self._fold(L)
            idx = ((pc >> 2) ^ f ^ (f << 1)) % self.entries
            tag = ((pc >> 2) ^ (f * 3)) & 0xFFFF
            yield t, idx, tag

    def _provider(self, pc: int):
        provider = None
        for t, idx, tag in self._indices(pc):
            if self.tag[t, idx] == tag:
                provider = (t, idx)
        return provider

    def predict(self, pc: int) -> bool:
        prov = self._provider(pc)
        if prov is not None:
            t, idx = prov
            return self.ctr[t, idx] >= 2
        return self.base[(pc >> 2) % self.entries] >= 2

    def update(self, pc: int, taken: bool) -> None:
        prov = self._provider(pc)
        pred = self.predict(pc)
        if prov is not None:
            t, idx = prov
            _ctr_update(self.ctr[t], idx, taken)
            if pred == taken and self.useful[t, idx] < 3:
                self.useful[t, idx] += 1
        else:
            _ctr_update(self.base, (pc >> 2) % self.entries, taken)
        # On a mispredict, allocate in a longer-history table.
        if pred != taken:
            start = (prov[0] + 1) if prov is not None else 0
            for t, idx, tag in self._indices(pc):
                if t < start:
                    continue
                if self.useful[t, idx] == 0:
                    self.tag[t, idx] = tag
                    self.ctr[t, idx] = 2 if taken else 1
                    break
                self.useful[t, idx] -= 1
        self.ghist = ((self.ghist << 1) | int(taken)) & ((1 << 64) - 1)


_REGISTRY = {
    "Local": LocalBP,
    "BiMode": BiModeBP,
    "Tournament": TournamentBP,
    "TAGE_SC_L": TageLiteBP,
}


def make_predictor(name: str) -> _Base:
    if name not in _REGISTRY:
        raise KeyError(f"unknown branch predictor {name!r}; have {PREDICTOR_NAMES}")
    return _REGISTRY[name]()
