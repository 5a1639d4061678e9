"""FNV-1a hashing + hashbrown (SwissTable) iteration-order emulation.

The reference's per-read k-mer sets are ``fnv::FnvHashSet<String>`` —
``std::collections::HashSet`` with the FNV build hasher — and its
classification output depends on their *iteration order*:

- ``search_index_classic`` breaks out of the whole k-mer loop at the first
  k-mer with an absent Bloom row (read_id_mt_pe.rs:88-89), so which k-mers
  were counted before the break depends on set order;
- ``search_index`` (``-B``) builds its candidate color set from the first
  ``start_sample`` k-mers *in set order* (read_id_mt_pe.rs:115-139);
- ``kmer_poll_plus`` stable-sorts the report map's iteration order by count
  (read_id_mt_pe.rs:195-196), so tied top hits are emitted in
  ``FnvHashMap`` order;
- ``read_counts_five_fields`` writes the counts file in ``FnvHashMap``
  order (reports.rs:98-120).

FNV hashing is deterministic (no RandomState), so the real binary's order
is reproducible. This module transcribes the exact semantics; the C++ twin
in native/ingest.cpp (ct_fnv_ranks) is the production fast path and is
cross-validated against this implementation in tests/test_fnv_order.py.

Transcribed semantics (no Rust toolchain exists in this environment, so
these are pinned assumptions, recorded here and in PARITY.md):

- fnv crate 1.0: FNV-1a 64-bit — ``hash = (hash ^ byte) * 0x100000001b3``
  starting from ``0xcbf29ce484222325``.
- ``Hash for str/String``: writes the bytes, then a ``0xff`` terminator.
- ``Hash for usize`` (64-bit target): writes 8 little-endian bytes.
- hashbrown (std HashMap/HashSet since Rust 1.36) on x86_64/SSE2:
  * group width 16, ``h1 = hash & bucket_mask``, ``h2`` = top 7 bits;
  * triangular probing: ``stride += 16; pos = (pos + stride) & mask``;
  * within a probe group, the lowest-index EMPTY/DELETED control byte wins;
    for tables smaller than one group, a wrapped slot that lands on a FULL
    bucket falls back to the lowest EMPTY slot of the aligned group at 0;
  * control bytes are mirrored into a 16-byte tail so unaligned group loads
    wrap (``set_ctrl``: mirror index ``((i - 16) mod buckets) + 16``);
  * capacity = ``buckets - 1`` for buckets < 8, else ``buckets * 7 / 8``;
    growth resizes to ``capacity_to_buckets(items + 1)`` where
    ``capacity_to_buckets(c)`` = 4 if c < 4, 8 if c < 8, else
    ``next_power_of_two(c * 8 / 7)``;
  * a resize re-inserts the live items in ascending-bucket order;
  * iteration (RawIter) yields occupied buckets in ascending index order.

Inserting an element that is already present never mutates the table, so
replaying only the first occurrences (in first-occurrence order) is exact.
"""

from __future__ import annotations

import functools

import numpy as np

FNV_OFFSET = np.uint64(0xCBF29CE484222325)
FNV_PRIME = np.uint64(0x100000001B3)
_GROUP = 16


def fnv1a64(data: bytes) -> int:
    """FNV-1a 64-bit of raw bytes (the fnv crate's Hasher::write)."""
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def fnv1a64_str(data: bytes) -> int:
    """Hash of a Rust &str/String: bytes then the 0xff terminator."""
    h = fnv1a64(data)
    return ((h ^ 0xFF) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF


def fnv1a64_usize(value: int) -> int:
    """Hash of a Rust usize on a 64-bit LE target: 8 little-endian bytes."""
    return fnv1a64(int(value).to_bytes(8, "little"))


def fnv1a64_batch(keys: np.ndarray) -> np.ndarray:
    """Vectorized fnv1a64_str over byte rows [N, k] -> uint64 [N]."""
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    n, k = keys.shape
    h = np.full(n, FNV_OFFSET, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for j in range(k):
            h = (h ^ keys[:, j].astype(np.uint64)) * FNV_PRIME
        h = (h ^ np.uint64(0xFF)) * FNV_PRIME
    return h


def _capacity_to_buckets(cap: int) -> int:
    if cap < 4:
        return 4
    if cap < 8:
        return 8
    adjusted = cap * 8 // 7
    return 1 << (adjusted - 1).bit_length()


def _bucket_mask_to_capacity(mask: int) -> int:
    return mask if mask < 8 else (mask + 1) // 8 * 7


class HashbrownOrder:
    """Replays unique-key inserts and reports the table's iteration order.

    Only the pieces that affect iteration order are modeled: control bytes,
    growth, and per-bucket payload = insertion index. No deletions (the
    reference never removes from these sets/maps).
    """

    def __init__(self) -> None:
        self.buckets = 0
        self.items = 0
        self.growth_left = 0
        self.ctrl = np.zeros(0, dtype=np.uint8)
        self.slot_ins = np.zeros(0, dtype=np.int64)  # insertion index
        self.slot_hash = np.zeros(0, dtype=np.uint64)

    def _find_insert_slot(self, h: int) -> int:
        mask = self.buckets - 1
        pos = h & mask
        stride = 0
        ctrl = self.ctrl
        while True:
            grp = ctrl[pos : pos + _GROUP]
            cand = np.nonzero(grp & 0x80)[0]  # EMPTY (0xff) or DELETED (0x80)
            if cand.size:
                result = (pos + int(cand[0])) & mask
                if not (ctrl[result] & 0x80):  # landed on a FULL slot:
                    # only possible when buckets < GROUP; take the lowest
                    # empty/deleted of the aligned group at 0
                    aligned = np.nonzero(ctrl[:_GROUP] & 0x80)[0]
                    result = int(aligned[0])
                return result
            stride += _GROUP
            pos = (pos + stride) & mask

    def _place(self, bucket: int, h: int, ins: int) -> None:
        h2 = np.uint8((h >> 57) & 0x7F)
        self.ctrl[bucket] = h2
        mirror = ((bucket - _GROUP) % self.buckets) + _GROUP
        self.ctrl[mirror] = h2
        self.slot_ins[bucket] = ins
        self.slot_hash[bucket] = h

    def _resize(self, new_buckets: int) -> None:
        old_ctrl = self.ctrl
        old_ins = self.slot_ins
        old_hash = self.slot_hash
        old_buckets = self.buckets
        self.buckets = new_buckets
        self.ctrl = np.full(new_buckets + _GROUP, 0xFF, dtype=np.uint8)
        self.slot_ins = np.full(new_buckets, -1, dtype=np.int64)
        self.slot_hash = np.zeros(new_buckets, dtype=np.uint64)
        for i in range(old_buckets):  # RawIter order: ascending buckets
            if not (old_ctrl[i] & 0x80):
                b = self._find_insert_slot(int(old_hash[i]))
                self._place(b, int(old_hash[i]), int(old_ins[i]))
        self.growth_left = _bucket_mask_to_capacity(new_buckets - 1) - self.items

    def insert(self, h: int, ins: int) -> None:
        """Insert a NOT-already-present key with hash ``h``; ``ins`` is its
        insertion sequence number (payload for order reporting)."""
        if self.growth_left == 0:
            self._resize(_capacity_to_buckets(self.items + 1))
        b = self._find_insert_slot(h)
        self._place(b, h, ins)
        self.items += 1
        self.growth_left -= 1

    def iteration_order(self) -> np.ndarray:
        """Insertion indices in table iteration order (ascending buckets)."""
        if self.buckets == 0:
            return np.zeros(0, dtype=np.int64)
        full = ~(self.ctrl[: self.buckets] & 0x80).astype(bool)
        return self.slot_ins[: self.buckets][full]


def hashbrown_iteration_order(hashes) -> np.ndarray:
    """Iteration order (as insertion indices) after inserting unique keys
    with the given 64-bit hashes, in order."""
    t = HashbrownOrder()
    for i, h in enumerate(hashes):
        t.insert(int(h), i)
    return t.iteration_order()


def fnv_set_ranks(hashes) -> np.ndarray:
    """ranks[i] = iteration position of the i-th inserted unique key."""
    order = hashbrown_iteration_order(hashes)
    ranks = np.empty(len(order), dtype=np.int64)
    ranks[order] = np.arange(len(order))
    return ranks


def fnv_reorder_keys(keys: np.ndarray) -> np.ndarray:
    """Reorder unique k-mer byte rows [N, k] (first-occurrence order) into
    FnvHashSet iteration order, so index == iteration position."""
    if keys.shape[0] <= 1:
        return keys
    order = hashbrown_iteration_order(fnv1a64_batch(keys))
    return keys[order]


def fnv_map_order_usize(keys_in_insertion_order) -> list[int]:
    """FnvHashMap<usize, _> iteration order for the given unique keys."""
    return list(_map_order_usize_cached(tuple(keys_in_insertion_order)))


@functools.lru_cache(maxsize=65536)
def _map_order_usize_cached(keys: tuple) -> tuple:
    # tied-read fixup calls this once per read with small color-id tuples
    # that repeat heavily across a batch; the table replay is pure in them
    order = hashbrown_iteration_order([fnv1a64_usize(k) for k in keys])
    return tuple(keys[i] for i in order)


def fnv_map_order_str(keys_in_insertion_order: list[bytes]) -> list[bytes]:
    """FnvHashMap<String, _> iteration order for the given unique keys."""
    order = hashbrown_iteration_order(
        [fnv1a64_str(k) for k in keys_in_insertion_order]
    )
    return [keys_in_insertion_order[i] for i in order]
