"""Kernel H: relative_vars' pair pass for every cluster of a window.

Relative_Vars (RepeatResolver.c:2424-2493; the JAX package's host code,
repeatresolver_tpu/models/resolver.py:534-570) marks, within one
cluster of rows, every selected group that has a significant partner:
for each pair (a, b) of selected groups whose indices lie at least 100
apart (sel[b] >= sel[a] + 100, 20 columns), the two-sided
hg.cum_hyp_geo_log(schnitt, gr[b], gr[a], cov=cluster size) above the
cutoff marks both. Its arguments are small integers: gr and schnitt
count the cluster's rows. So the card computes each pair's intersection
and looks its decision up in a table of bits that the host fills with
that very function (float64, its own numpy code, so a decision is the
host route's bit for bit), over the argument tuples that occur.

Layout (`PairPass`): the selected rows of all clusters, cluster by
cluster, groups ascending within one. Row r's membership in its
cluster's rows is packed 64 rows a word (words[k] = ceil(size_k / 64)
words a row, at masks[word_off[k] + (r - row_off[k]) * words[k]]); its
cluster rowk[r], its group sel[r] and gidx[r], the index of its
popcount among the dims[k] = D distinct popcounts of its table. An
entry of a table is a triple (s, gidx[b], gidx[a]): the decision for
schnitt s, gr[b], gr[a] (the host's argument order; the function is not
symmetric in them). Clusters of equal size share a table.

A table comes in one of two forms (kflag[k]):

- BITMAP, where its bits fit SMEM_TABLE_BYTES: entry (s, gb, ga) is bit
  ga % 32 of word s * S + gb * R + ga // 32, R = ceil(D / 32) words a
  (s, gb) row, S = D * R rounded up to odd (`table_geometry`), so that a
  warp's lanes, which differ in s, read distinct shared-memory banks.
  tab_words[k] words (a multiple of 4) at tab_off[k] of `tables` (the
  decisions) and of `occ` (the entries that occur).
- HASHED, past that: entry e = (s * D + gb) * D + ga, key hbase[k] + e
  + 1 (hbase spaces the tables apart in 64 bits) in a hash (`PairHash`)
  of the entries that occur, open addressing with linear probing from
  `hash_slot`, its decision bit beside it. HASHED_WIDE: the same, for a
  table of 2^32 entries or more (e in 64 bits on the card).

A pass runs twice. The counting launch (count=True) sets the occurrence
bit of every entry that occurs (BITMAP) or inserts its key (HASHED); the
host evaluates those entries alone and sets their decision bits; the
lookup launch marks the rows of every pair whose decision bit is set.
When the hashed keys that occur pass half the slots, the counting
launch sets the overflow flag (the kernel and the plain version alike,
however the kernel's inserts race): the caller retries with a larger
hash (`HASH_LOG2_START`, grown by `HASH_LOG2_STEP`). The hash holds at
most as many keys as the counted clusters have pairs, so no table size
is refused.

Work is cut into tiles (`pair_tiles`, [T, 4] int32 rows (k, a0, b0,
b1)): TILE_A a-rows from a0 against the b-rows [b0, b1) of cluster k,
the b-range starting at the first row 100 groups past a0 and cut into
near-equal chunks of at most TILE_B rows. Together the tiles hold every
pair of the pass; a tile may also hold rows that are no pair (b not far
enough past a), which both versions skip. The marks are a packed bitmap
(`marked`, int32 words, bit r % 32 of word r // 32).

`pair_pass` launches csrc/resolver_pairs.cu on CUDA tensors (a CTA a
tile: the BITMAP table staged in shared memory, the b-rows staged, the
a-rows in registers; one launch a pass) and runs `pair_pass_plain` (the
same function in torch ops, over batches of tiles) on CPU tensors. Racing
inserts leave the kernel's keys in other slots than the plain version's;
both find a key wherever either put it; the occurrence bits are the
same bits. `pair_pass.launches` counts the kernel's launches. The kernel
replaces no Pallas kernel: the JAX package ran this loop on the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import _build

# indices of two selected groups at least this far apart form a pair
# (RepeatResolver.c:2452: 20 columns of 5 groups)
ROW_GAP = 100
# a table of at most this many bytes of bits is counted and looked up in
# shared memory (BITMAP); a larger one in the hash. The H100 gives a
# block at most 227 KB (232,448 B) of shared memory when it opts in, of
# an SM's 228 KB: 96 KiB of table beside a CTA's TILE_B x 16 B of staged
# b-rows lets two CTAs share an SM
SMEM_TABLE_BYTES = 96 * 1024
# a tile's a-rows (the kernel's TA: 32 lanes x 4 rows) and the b-rows
# the kernel stages at a time (its NB), the tiler's chunk
TILE_A = 128
TILE_B = 1024
# the hash's first size (log2 of its slots: 64 MiB of keys at most) and
# its growth after an overflow
HASH_LOG2_START = 23
HASH_LOG2_STEP = 2
# kflag: a table's form
BITMAP, HASHED, HASHED_WIDE = 0, 1, 2
# pair_pass_plain's batch: tiles x TILE_A x b-rows x words, elements
PLAIN_BLOCK = 1 << 22


def table_geometry(d: int) -> tuple[int, int]:
    """(R, S) of a BITMAP table over d distinct popcounts: R words a
    (s, gb) row, S words an s (D * R rounded up to odd)."""
    r = (d + 31) // 32
    return r, (d * r) | 1


def bitmap_words(d: int, vmax: int) -> int:
    """Words of a BITMAP table over d distinct popcounts, the largest
    vmax, rounded up to a multiple of 4 (the kernel stages 16 B at a
    time)."""
    return -(-(vmax + 1) * table_geometry(d)[1] // 4) * 4


@dataclass
class PairPass:
    """The packed inputs of one window's pair pass, on one device (see
    the module's docstring). int64 masks (uint64 words) and hbase, int32
    rest; row_off has K + 1 entries, the other per-cluster arrays K;
    tiles [T, 4]."""
    masks: torch.Tensor
    sel: torch.Tensor
    gidx: torch.Tensor
    rowk: torch.Tensor
    row_off: torch.Tensor
    word_off: torch.Tensor
    words: torch.Tensor
    tab_off: torch.Tensor
    tab_words: torch.Tensor
    dims: torch.Tensor
    kflag: torch.Tensor
    hbase: torch.Tensor
    tiles: torch.Tensor

    @property
    def nrows(self) -> int:
        return self.sel.shape[0]

    @property
    def nclusters(self) -> int:
        return self.words.shape[0]


@dataclass
class PairHash:
    """The hash of a pass's counted entries: keys int64 [2^log2] (0 an
    empty slot, else key hbase[k] + e + 1), bits uint8 [2^log2] (the
    decision of the key in the same slot), state int64 [2] (keys put in,
    overflow flag)."""
    keys: torch.Tensor
    bits: torch.Tensor
    state: torch.Tensor

    @classmethod
    def empty(cls, log2: int, device) -> "PairHash":
        n = 1 << log2
        return cls(torch.zeros(n, dtype=torch.int64, device=device),
                   torch.zeros(n, dtype=torch.uint8, device=device),
                   torch.zeros(2, dtype=torch.int64, device=device))

    @property
    def log2(self) -> int:
        return self.keys.shape[0].bit_length() - 1

    def overflowed(self) -> bool:
        return bool(self.state[1].item())


def hash_slot(keys: torch.Tensor, log2: int) -> torch.Tensor:
    """The kernel's hash_slot: the top log2 bits of a 32-bit product of
    each half of the key (int64 keys below 2^63; the products stay
    below 2^63)."""
    m32 = 0xFFFFFFFF
    h = (((keys & m32) * 0x9E3779B1) & m32) \
        ^ ((((keys >> 32) & m32) * 0x85EBCA77) & m32)
    return h >> (32 - log2)


def hash_find(h: PairHash, keys: torch.Tensor) -> torch.Tensor:
    """The slot of each key in h, or -1 where it is absent: probes from
    hash_slot until the key or an empty slot."""
    mask = (1 << h.log2) - 1
    slot = torch.full_like(keys, -1)
    pos = hash_slot(keys, h.log2)
    live = torch.arange(keys.shape[0], device=keys.device)
    while live.numel():
        cur = h.keys[pos[live]]
        hit = cur == keys[live]
        slot[live[hit]] = pos[live[hit]]
        live = live[~hit & (cur != 0)]
        pos[live] = (pos[live] + 1) & mask
    return slot


def hash_insert_plain(h: PairHash, keys: torch.Tensor) -> None:
    """Insert the keys into h as the kernel does, one round of probes at
    a time (the first key in order takes a contested empty slot); if the
    keys would pass half the slots, set the overflow flag instead."""
    if keys.numel() == 0 or h.overflowed():
        return
    keys = torch.unique(keys)
    keys = keys[hash_find(h, keys) < 0]
    filled = int(h.state[0])
    if filled + keys.numel() > (1 << h.log2) >> 1:
        h.state[1] = 1
        return
    h.state[0] += keys.numel()
    mask = (1 << h.log2) - 1
    pos = hash_slot(keys, h.log2)
    while keys.numel():
        cand = torch.nonzero(h.keys[pos] == 0).flatten()
        at, inv = torch.unique(pos[cand], return_inverse=True)
        first = torch.full_like(at, keys.numel()).scatter_reduce_(
            0, inv, cand, "amin")
        won = torch.zeros_like(keys, dtype=torch.bool)
        won[first] = True
        h.keys[pos[won]] = keys[won]
        keys, pos = keys[~won], (pos[~won] + 1) & mask


def pack_members(groups: torch.Tensor, u: torch.Tensor, ks: torch.Tensor,
                 kk: torch.Tensor, gg: torch.Tensor):
    """Each selected group's membership in its cluster's rows, packed.

    groups int8 [G, n] (0/1), u int64 [n] labels >= 0, ks int64 [K] the
    clusters, kk and gg int64 [N] the selected rows' cluster (index into
    ks, ascending) and group. A cluster's rows are its members in
    ascending row order, 64 to a word (bit j of word j // 64). Returns
    (masks int64, gr int32 [N] popcounts, row_off int32 [K + 1],
    word_off int32 [K], words int32 [K], sizes int64 [K])."""
    dev = groups.device
    n = u.shape[0]
    k_n = ks.shape[0]
    order = torch.sort(u, stable=True).indices
    cnt_all = torch.bincount(u, minlength=int(ks.max()) + 1 if k_n else 1)
    sizes = cnt_all[ks]
    starts = (torch.cumsum(cnt_all, 0) - cnt_all)[ks]
    words = (sizes + 63) // 64
    nsel = torch.bincount(kk, minlength=k_n)
    row_off = torch.zeros(k_n + 1, dtype=torch.int64, device=dev)
    row_off[1:] = torch.cumsum(nsel, 0)
    cl_words = nsel * words
    word_off = torch.cumsum(cl_words, 0) - cl_words
    wr = words[kk]
    row_word = torch.cumsum(wr, 0) - wr
    total = int(cl_words.sum()) if k_n else 0
    if total >= 2 ** 31:
        raise ValueError(f"pack_members: {total} words pass int32 offsets")
    masks = torch.zeros(total, dtype=torch.int64, device=dev)
    gr = torch.zeros(kk.shape[0], dtype=torch.int32, device=dev)
    shifts = torch.arange(64, dtype=torch.int64, device=dev)
    for w in torch.unique(wr).tolist():
        rows_w = torch.nonzero(wr == w).flatten()
        j = torch.arange(w * 64, device=dev)
        step = max(1, (1 << 24) // (w * 64))
        for lo in range(0, rows_w.shape[0], step):
            r = rows_w[lo:lo + step]
            k_r = kk[r]
            valid = j[None, :] < sizes[k_r][:, None]
            pos = (starts[k_r][:, None] + j[None, :]).clamp(max=n - 1)
            bits = groups[gg[r][:, None], order[pos]] * valid
            gr[r] = bits.sum(1, dtype=torch.int32)
            packed = (bits.view(-1, w, 64).to(torch.int64) << shifts).sum(-1)
            masks[row_word[r][:, None]
                  + torch.arange(w, device=dev)[None, :]] = packed
    i32 = torch.int32
    return (masks, gr, row_off.to(i32), word_off.to(i32), words.to(i32),
            sizes)


def pair_tiles(sel: torch.Tensor, rowk: torch.Tensor,
               row_off: torch.Tensor) -> torch.Tensor:
    """The tiles of a pass, int32 [T, 4] rows (k, a0, b0, b1), in torch
    ops on sel's device: for each cluster k, a-tiles of TILE_A rows from
    its first row, each against its b-rows from the first whose group
    lies ROW_GAP past a0's (sel ascending within a cluster) to the
    cluster's end, in ceil(len / TILE_B) chunks whose lengths differ by
    at most one row.
    An a-tile with no such b-row has no tile."""
    dev = sel.device
    empty = torch.zeros((0, 4), dtype=torch.int32, device=dev)
    if sel.shape[0] == 0:
        return empty
    lo = row_off[:-1].to(torch.int64)
    hi = row_off[1:].to(torch.int64)
    na = (hi - lo + TILE_A - 1) // TILE_A
    k = torch.repeat_interleave(torch.arange(lo.shape[0], device=dev), na)
    first = torch.cumsum(na, 0) - na
    a0 = lo[k] + (torch.arange(k.shape[0], device=dev) - first[k]) * TILE_A
    key = (rowk.to(torch.int64) << 32) | sel.to(torch.int64)
    b0 = torch.searchsorted(key, key[a0] + ROW_GAP)
    end = hi[k]
    b0 = torch.minimum(b0, end)
    span = end - b0
    live = span > 0
    k, a0, b0, end, span = (x[live] for x in (k, a0, b0, end, span))
    if k.numel() == 0:
        return empty
    nch = (span + TILE_B - 1) // TILE_B
    t = torch.repeat_interleave(torch.arange(k.shape[0], device=dev), nch)
    c = torch.arange(t.shape[0], device=dev) - (torch.cumsum(nch, 0)
                                                - nch)[t]
    tb0 = b0[t] + c * span[t] // nch[t]
    tb1 = b0[t] + (c + 1) * span[t] // nch[t]
    return torch.stack([k[t], a0[t], tb0, tb1], 1).to(torch.int32)


def or_words(region: torch.Tensor, word: torch.Tensor,
             bit: torch.Tensor) -> None:
    """Set bit `bit` of word `word` of the int32 `region` (in place) for
    every pair of the int64 tensors word, bit."""
    if word.numel() == 0:
        return
    flat = torch.unique(word * 32 + bit)
    at, inv = torch.unique(flat >> 5, return_inverse=True)
    acc = torch.zeros(at.shape[0], dtype=torch.int64, device=region.device)
    acc.index_add_(0, inv, torch.ones_like(flat) << (flat & 31))
    acc = torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc)   # as int32 bits
    region[at] |= acc.to(torch.int32)


def unpack_marks(marked: torch.Tensor, n: int) -> np.ndarray:
    """The packed marks (int32 words) as a host bool array of n rows."""
    words = marked.cpu().numpy().astype("<i4")
    return np.unpackbits(words.view(np.uint8),
                         bitorder="little")[:n].astype(bool)


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 (read as uint64): the SWAR count of each
    32-bit half, which stays non-negative and far from overflow."""
    def half(v):
        v = v - ((v >> 1) & 0x55555555)
        v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
        v = (v + (v >> 4)) & 0x0F0F0F0F
        return ((v * 0x01010101) >> 24) & 0xFF
    return half(x & 0xFFFFFFFF) + half((x >> 32) & 0xFFFFFFFF)


def _check_pass(p: PairPass, tables, occ, h: PairHash, marked, dev):
    n, k_n = p.nrows, p.nclusters
    spec = [("masks", p.masks, torch.int64, None),
            ("sel", p.sel, torch.int32, n), ("gidx", p.gidx, torch.int32, n),
            ("rowk", p.rowk, torch.int32, n),
            ("row_off", p.row_off, torch.int32, k_n + 1),
            ("word_off", p.word_off, torch.int32, k_n),
            ("words", p.words, torch.int32, k_n),
            ("tab_off", p.tab_off, torch.int32, k_n),
            ("tab_words", p.tab_words, torch.int32, k_n),
            ("dims", p.dims, torch.int32, k_n),
            ("kflag", p.kflag, torch.int32, k_n),
            ("hbase", p.hbase, torch.int64, k_n),
            ("tables", tables, torch.int32, None),
            ("occ", occ, torch.int32, tables.shape[0]),
            ("hash keys", h.keys, torch.int64, None),
            ("hash bits", h.bits, torch.uint8, h.keys.shape[0]),
            ("hash state", h.state, torch.int64, 2),
            ("marked", marked, torch.int32, (n + 31) // 32)]
    for name, x, dtype, size in spec:
        if not isinstance(x, torch.Tensor) or x.dtype != dtype \
                or x.dim() != 1 or not x.is_contiguous() \
                or (size is not None and x.shape[0] != size):
            raise ValueError(f"pair_pass: {name} must be a contiguous 1-d "
                             f"{dtype} tensor"
                             + (f" of {size}" if size is not None else ""))
        if x.device != dev:
            raise ValueError(f"pair_pass: {name} is on {x.device}, "
                             f"expected {dev}")
    t = p.tiles
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 \
            or t.dim() != 2 or t.shape[1] != 4 or not t.is_contiguous() \
            or t.device != dev:
        raise ValueError(f"pair_pass: tiles must be a contiguous [T, 4] "
                         f"int32 tensor on {dev}")
    slots = h.keys.shape[0]
    if slots < 2 or slots & (slots - 1) or slots > 1 << 31:
        raise ValueError(f"pair_pass: the hash has {slots} slots, not a "
                         "power of two in [2, 2^31]")


def _bitmap_cap(p: PairPass, tables) -> int:
    """The words of the largest BITMAP table (the kernel's shared-memory
    table), after checking that every BITMAP table is 16-byte aligned
    and lies inside `tables`."""
    if p.nclusters == 0:
        return 0
    bm = p.kflag == BITMAP
    off, tw = p.tab_off.to(torch.int64), p.tab_words.to(torch.int64)
    bad = bm & ((off < 0) | (tw < 0) | (off % 4 != 0) | (tw % 4 != 0)
                | (off + tw > tables.shape[0]))
    cap, bad = torch.stack([torch.where(bm, tw, 0).max(),
                            bad.any().to(torch.int64)]).tolist()
    if bad:
        raise ValueError("pair_pass: a BITMAP table is unaligned or lies "
                         "outside tables")
    return cap


def pair_pass(p: PairPass, tables: torch.Tensor, occ: torch.Tensor,
              h: PairHash, marked: torch.Tensor, count: bool = False
              ) -> None:
    """Kernel H on CUDA tensors, pair_pass_plain on CPU tensors.

    count=True: set the bit of `occ` of every BITMAP entry that occurs
    in a pair, and insert the key of every HASHED one into h (empty, or
    holding earlier keys); h.overflowed() then says whether it ran out
    of room, and the pass must be run again on a larger hash.
    count=False: for every pair whose decision bit is set (in `tables`
    for a BITMAP table, beside its key in h for a HASHED one), set both
    rows' bits in the packed `marked` (zeroed by the caller)."""
    dev = marked.device
    _check_pass(p, tables, occ, h, marked, dev)
    if dev.type == "cpu":
        pair_pass_plain(p, tables, occ, h, marked, count)
        return
    if dev.type != "cuda":
        raise ValueError(f"pair_pass: CUDA or CPU tensors, got {dev}")
    if p.tiles.shape[0] == 0:
        return
    cap = _bitmap_cap(p, tables)
    lib = _build.load("resolver_pairs")
    ptr = _build.ptr
    ev = _build.launch_events("resolver_pairs")
    if ev:
        ev[0].record()
    err = lib.resolver_pairs_launch(
        ptr(p.tiles), ptr(p.masks), ptr(p.sel), ptr(p.gidx), ptr(p.row_off),
        ptr(p.word_off), ptr(p.words), ptr(p.tab_off), ptr(p.tab_words),
        ptr(p.dims), ptr(p.kflag), ptr(p.hbase), ptr(tables), ptr(occ),
        ptr(h.keys), ptr(h.bits), ptr(h.state), ptr(marked),
        p.tiles.shape[0], p.nclusters, int(bool(count)), ROW_GAP, h.log2,
        cap, _build.stream_ptr(dev))
    if ev:
        ev[1].record()
    _build.check(lib, "resolver_pairs", err)
    pair_pass.launches += 1


pair_pass.launches = 0


def pair_pass_plain(p: PairPass, tables: torch.Tensor, occ: torch.Tensor,
                    h: PairHash, marked: torch.Tensor, count: bool = False
                    ) -> None:
    """Kernel H's function in torch ops over the same tiles: the tiles
    of one form and one word count at a time, as many as PLAIN_BLOCK
    elements of a batch of [TILE_A, b-rows, words] intersections hold;
    the same inputs and outputs as pair_pass."""
    dev = marked.device
    i64 = torch.int64
    t = p.tiles.to(i64)
    if t.shape[0] == 0:
        return
    k = t[:, 0]
    lo = p.row_off.to(i64)[k]
    hi = p.row_off.to(i64)[k + 1]
    a0, b0, b1 = t[:, 1], t[:, 2], t[:, 3]
    a1 = torch.minimum(a0 + TILE_A, hi)
    w_t = p.words.to(i64)[k]
    form = p.kflag.to(i64)[k]
    d = p.dims.to(i64)[k]
    rr = (d + 31) // 32
    ss = (d * rr) | 1
    base = torch.where(form == BITMAP, p.tab_off.to(i64)[k],
                       p.hbase.to(i64)[k] + 1)
    woff = p.word_off.to(i64)[k]
    sel, gidx = p.sel.to(i64), p.gidx.to(i64)
    hits = torch.zeros(p.nrows, dtype=torch.bool, device=dev)
    keys, occ_at = [], []
    groups = torch.unique(torch.stack([form == BITMAP, w_t], 1), dim=0)
    for is_bitmap, w in groups.tolist():
        idx = torch.nonzero(((form == BITMAP) == bool(is_bitmap))
                            & (w_t == w)).flatten()
        nb_max = int((b1 - b0)[idx].max())
        step = max(1, PLAIN_BLOCK // (TILE_A * nb_max * w))
        for c in range(0, idx.shape[0], step):
            g = idx[c:c + step]
            ar = a0[g, None] + torch.arange(TILE_A, device=dev)
            br = b0[g, None] + torch.arange(nb_max, device=dev)
            a_ok = ar < a1[g, None]
            b_ok = br < b1[g, None]
            ar = torch.where(a_ok, ar, a0[g, None])
            br = torch.where(b_ok, br, b0[g, None])
            j = torch.arange(w, device=dev)
            ma = p.masks[woff[g, None, None] + (ar - lo[g, None])[:, :, None]
                         * w + j]
            mb = p.masks[woff[g, None, None] + (br - lo[g, None])[:, :, None]
                         * w + j]
            s = popcount64(ma[:, :, None, :] & mb[:, None, :, :]).sum(-1)
            pair = a_ok[:, :, None] & b_ok[:, None, :] & (
                sel[br][:, None, :] >= sel[ar][:, :, None] + ROW_GAP)
            ga, gb = gidx[ar][:, :, None], gidx[br][:, None, :]
            gg = g[:, None, None]
            if is_bitmap:
                word = base[gg] + s * ss[gg] + gb * rr[gg] + (ga >> 5)
                bit = (ga & 31).expand_as(word)
                if count:
                    occ_at.append(torch.unique(word[pair] * 32 + bit[pair]))
                    continue
                hit = pair & (((tables[word] >> bit.to(torch.int32)) & 1)
                              == 1)
            else:
                key = (s * d[gg] + gb) * d[gg] + ga + base[gg]
                if count:
                    keys.append(torch.unique(key[pair]))
                    continue
                hit = torch.zeros_like(pair)
                slot = hash_find(h, key[pair])
                hit[pair] = (slot >= 0) & (h.bits[slot.clamp(min=0)] != 0)
            hits[ar[hit.any(2)]] = True
            hits[br[hit.any(1)]] = True
    if count:
        if occ_at:
            flat = torch.cat(occ_at)
            or_words(occ, flat >> 5, flat & 31)
        if keys:
            hash_insert_plain(h, torch.cat(keys))
        return
    rows = torch.nonzero(hits).flatten()
    or_words(marked, rows >> 5, rows & 31)
