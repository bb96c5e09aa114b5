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
popcount among the distinct popcounts of its table. A table of
dims[k] = D distinct values has entry e = (s * D + gidx[b]) * D +
gidx[a]: the decision for schnitt s, gr[b], gr[a] (the host's argument
order; the function is not symmetric in them). Clusters of equal size
share a table.

A table of at most FULL_TABLE_MAX entries is dense: bit e at word
tab_off[k] + e // 32, bit e % 32 of `tables`, every entry filled by the
host. A larger one (kflag[k] set) has as many entries as the cluster
size cubed, so it lives in a hash (`PairHash`) of the entries that
occur: key hbase[k] + e + 1 (hbase spaces the tables apart in 64 bits),
open addressing with linear probing from `hash_slot`, its decision bit
beside it. A first launch in counting mode inserts every key that
occurs; the host evaluates those keys alone and sets their bits; the
lookup launch then reads them. When the keys that occur pass half the
slots, the counting launch sets the overflow flag (the kernel and the
plain version alike, however the kernel's inserts race): the caller
retries with a larger hash (`HASH_LOG2_START`, grown by
`HASH_LOG2_STEP`). The hash holds at most as many keys as the counted
clusters have pairs, so no table size is refused.

`pair_pass` launches csrc/resolver_pairs.cu on CUDA tensors (a warp a
row a, b from a binary search on the sorted sel, each pair's
intersection by AND and popcount over the packed words, the table's or
the hash's bit, idempotent byte stores for the marks) and runs
`pair_pass_plain` (the same function in torch ops, blocked over rows)
on CPU tensors. Racing inserts leave the kernel's keys in other slots
than the plain version's; both find a key wherever either put it.
`pair_pass.launches` counts the kernel's launches. The kernel replaces
no Pallas kernel: the JAX package ran this loop on the host. It is
bound by its operations (words x pairs AND + popcount + add, and a
table or hash load a pair); a dense table stays in L1, the hash in L2.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _build

# indices of two selected groups at least this far apart form a pair
# (RepeatResolver.c:2452: 20 columns of 5 groups)
ROW_GAP = 100
# a table of at most this many entries is filled whole by the host; a
# larger one only at the entries the counting launch found, in the hash
FULL_TABLE_MAX = 1 << 12
# the hash's first size (log2 of its slots: 64 MiB of keys at most) and
# its growth after an overflow
HASH_LOG2_START = 23
HASH_LOG2_STEP = 2
# pair_pass_plain's block: rows a x rows b x words, elements
PLAIN_BLOCK = 1 << 22


@dataclass
class PairPass:
    """The packed inputs of one window's pair pass, on one device (see
    the module's docstring). int64 masks (uint64 words) and hbase, int32
    rest; row_off has K + 1 entries, the other per-cluster arrays K."""
    masks: torch.Tensor
    sel: torch.Tensor
    gidx: torch.Tensor
    rowk: torch.Tensor
    row_off: torch.Tensor
    word_off: torch.Tensor
    words: torch.Tensor
    tab_off: torch.Tensor
    dims: torch.Tensor
    kflag: torch.Tensor
    hbase: torch.Tensor

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
    """The kernel's hash_slot: int64 keys below 2^63, two products below
    2^62 (no overflow), bits 24 up of their XOR."""
    h = (((keys & 0x7FFFFFFF) * 0x6C8E9CF5)
         ^ ((keys >> 31) * 0x165667B1))
    return (h >> 24) & ((1 << log2) - 1)


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


def or_bits(region: torch.Tensor, entries: torch.Tensor) -> None:
    """Set bit e % 32 of word e // 32 of the int32 `region` (in place)
    for every entry e of the int64 `entries` (distinct)."""
    if entries.numel() == 0:
        return
    nw = int(entries.max()) // 32 + 1
    acc = torch.zeros(nw, dtype=torch.int64, device=region.device)
    acc.index_add_(0, entries >> 5, torch.ones_like(entries) << (entries & 31))
    acc = torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc)   # as int32 bits
    region[:nw].bitwise_or_(acc.to(torch.int32))


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 (read as uint64): the SWAR count of each
    32-bit half, which stays non-negative and far from overflow."""
    def half(v):
        v = v - ((v >> 1) & 0x55555555)
        v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
        v = (v + (v >> 4)) & 0x0F0F0F0F
        return ((v * 0x01010101) >> 24) & 0xFF
    return half(x & 0xFFFFFFFF) + half((x >> 32) & 0xFFFFFFFF)


def _check_pass(p: PairPass, tables, h: PairHash, marked, dev):
    n, k_n = p.nrows, p.nclusters
    spec = [("masks", p.masks, torch.int64, None),
            ("sel", p.sel, torch.int32, n), ("gidx", p.gidx, torch.int32, n),
            ("rowk", p.rowk, torch.int32, n),
            ("row_off", p.row_off, torch.int32, k_n + 1),
            ("word_off", p.word_off, torch.int32, k_n),
            ("words", p.words, torch.int32, k_n),
            ("tab_off", p.tab_off, torch.int32, k_n),
            ("dims", p.dims, torch.int32, k_n),
            ("kflag", p.kflag, torch.int32, k_n),
            ("hbase", p.hbase, torch.int64, k_n),
            ("tables", tables, torch.int32, None),
            ("hash keys", h.keys, torch.int64, None),
            ("hash bits", h.bits, torch.uint8, h.keys.shape[0]),
            ("hash state", h.state, torch.int64, 2),
            ("marked", marked, torch.uint8, n)]
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
    slots = h.keys.shape[0]
    if slots < 2 or slots & (slots - 1) or slots > 1 << 31:
        raise ValueError(f"pair_pass: the hash has {slots} slots, not a "
                         "power of two in [2, 2^31]")


def pair_pass(p: PairPass, tables: torch.Tensor, h: PairHash,
              marked: torch.Tensor, count: bool = False) -> None:
    """Kernel H on CUDA tensors, pair_pass_plain on CPU tensors.

    count=False: for every pair of every cluster, a set bit of the
    cluster's dense table, or of its key in h (kflag set), marks both
    rows (marked[r] = 1; marked is zeroed by the caller). count=True:
    for the clusters with kflag set, insert every pair's key into h
    (empty, or holding earlier keys); h.overflowed() then says whether
    it ran out of room, and the pass must be run again on a larger
    hash."""
    dev = marked.device
    _check_pass(p, tables, h, marked, dev)
    if dev.type == "cpu":
        pair_pass_plain(p, tables, h, marked, count)
        return
    if dev.type != "cuda":
        raise ValueError(f"pair_pass: CUDA or CPU tensors, got {dev}")
    if p.nrows == 0:
        return
    lib = _build.load("resolver_pairs")
    ptr = _build.ptr
    ev = _build.launch_events("resolver_pairs")
    if ev:
        ev[0].record()
    err = lib.resolver_pairs_launch(
        ptr(p.masks), ptr(p.sel), ptr(p.gidx), ptr(p.rowk), ptr(p.row_off),
        ptr(p.word_off), ptr(p.words), ptr(p.tab_off), ptr(p.dims),
        ptr(p.kflag), ptr(p.hbase), ptr(tables), ptr(h.keys), ptr(h.bits),
        ptr(h.state), ptr(marked), p.nrows, int(bool(count)), ROW_GAP,
        h.log2, _build.stream_ptr(dev))
    if ev:
        ev[1].record()
    _build.check(lib, "resolver_pairs", err)
    pair_pass.launches += 1


pair_pass.launches = 0


def pair_pass_plain(p: PairPass, tables: torch.Tensor, h: PairHash,
                    marked: torch.Tensor, count: bool = False) -> None:
    """Kernel H's function in torch ops: per cluster, blocks of rows a
    against all rows b; the same inputs and outputs as pair_pass."""
    row_off = p.row_off.tolist()
    word_off, words = p.word_off.tolist(), p.words.tolist()
    tab_off, dims, kflag = p.tab_off.tolist(), p.dims.tolist(), \
        p.kflag.tolist()
    hbase = p.hbase.tolist()
    for k in range(p.nclusters):
        if count and not kflag[k]:
            continue
        lo, hi = row_off[k], row_off[k + 1]
        n, w, d = hi - lo, words[k], dims[k]
        if n == 0:
            continue
        m = p.masks[word_off[k]:word_off[k] + n * w].view(n, w)
        sel = p.sel[lo:hi].to(torch.int64)
        gi = p.gidx[lo:hi].to(torch.int64)
        hit_b = torch.zeros(n, dtype=torch.bool, device=m.device)
        step = max(1, PLAIN_BLOCK // (n * w))
        for a0 in range(0, n, step):
            a1 = min(a0 + step, n)
            s = popcount64(m[a0:a1, None, :] & m[None, :, :]).sum(-1)
            pair = sel[None, :] >= sel[a0:a1, None] + ROW_GAP
            e = (s * d + gi[None, :]) * d + gi[a0:a1, None]
            if count:
                hash_insert_plain(h, e[pair] + (hbase[k] + 1))
                continue
            if kflag[k]:
                hit = torch.zeros_like(pair)
                slot = hash_find(h, e[pair] + (hbase[k] + 1))
                hit[pair] = (slot >= 0) & (h.bits[slot.clamp(min=0)] != 0)
            else:
                word = tables[tab_off[k] + (e >> 5)]
                hit = (((word >> (e & 31).to(torch.int32)) & 1) == 1) & pair
            hit_b |= hit.any(0)
            marked[lo + a0:lo + a1] |= hit.any(1).to(torch.uint8)
        if not count:
            marked[lo:hi] |= hit_b.to(torch.uint8)
