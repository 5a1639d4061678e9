"""QueryEngine: device-resident index + chunked query execution.

Hosts the bit-slice matrix on the device once and streams k-mer batches
through the gather/AND/count ops. String work happens on the host; only
dense integer tensors cross to the device. Dense queries take a sorted
stream (ops/stream_query.py and its CUDA kernels): the row stream on a
classic index of <= 32 colors, the probe stream on a blocked v2/v3/v4 index
of <= 1024 colors. Everything else takes the generic gather (ops/query.py),
also an index placed for color shards (build --color-shards), whose streams
run on the sharded engine (parallel/engine.py), and a classic index past
int32 row addressing (bloom_size >= 2^31), whose rows the host hashes to
int64 for the generic gather's int64 word offsets.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from . import native
from .hashing.xxh3 import bloom_rows_batch
from .index.bigsi import BigsiIndex
from .ops.hash_torch import pack_keys_host
from .ops.query import (
    FREQ_CAP,
    new_accumulators,
    pack_matrix_blocks,
    query_accumulate_hash_scan,
    query_accumulate_hash_scan_exact,
    query_accumulate_scan,
)
from .ops.stream_query import STREAM_HASHES, STREAM_WPADS
from .runtime import resolve_device


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _i32(a: np.ndarray) -> torch.Tensor:
    """Host uint32/int32 array -> int32 tensor (bit view, no copy)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _pad_rows(pk: torch.Tensor, qc: torch.Tensor, unit: int):
    """Device k-mers [n, 2] and frequencies [n] zero-padded to a multiple
    of a stream's unit (qc == 0 marks padding)."""
    pad = _round_up(pk.shape[0], unit) - pk.shape[0]
    return (
        torch.cat([pk, pk.new_zeros((pad, 2))]),
        torch.cat([qc, qc.new_zeros(pad)]),
    )


def _dev_vec(stats, n_drop, hist, n_unique=None) -> torch.Tensor:
    """What a device-resident dispatch leaves for one fetch:
    cat([stats, n_drop, hist.ravel()]) (search_keys_dev_finish decodes it),
    or with the fused reads path's n_unique cat([stats, n_drop, n_unique,
    hist.ravel()]) (search_reads_fused_finish)."""
    mid = [n_drop.reshape(1)]
    if n_unique is not None:
        mid.append(n_unique.reshape(1).to(stats.dtype))
    return torch.cat([stats, *mid, hist.reshape(-1)])


@dataclass
class SearchResult:
    counts: np.ndarray  # int64 [C] per-color hit counts
    all_valid: bool  # every query k-mer had all rows present
    and_all: np.ndarray  # uint32 [W] global AND over k-mers
    freq_hist: np.ndarray  # int64 [C, FREQ_CAP] uniq-hit freq histogram
    over_colors: np.ndarray  # int32 [n_over] overflow colors
    over_freqs: np.ndarray  # int32 [n_over] overflow freqs (>= FREQ_CAP)

    def freq_stats(self) -> dict[int, tuple[float, int, int]]:
        """Exact per-color (mean, mode, n) of the uniq-hit k-mer frequency
        multiset (the reference's uniq_freqs, batch_search_pe.rs:75-83;
        mean/mode per reports.rs:8-77, ties -> smallest value)."""
        out: dict[int, tuple[float, int, int]] = {}
        C = self.freq_hist.shape[0]
        vals = np.arange(self.freq_hist.shape[1], dtype=np.int64)
        for c in range(C):
            h = self.freq_hist[c]
            n = int(h.sum())
            total = int((h * vals).sum())
            occ: dict[int, int] = {}
            nz = np.nonzero(h)[0]
            for v in nz:
                occ[int(v)] = int(h[v])
            sel = self.over_colors == c
            if sel.any():
                for f in self.over_freqs[sel]:
                    occ[int(f)] = occ.get(int(f), 0) + 1
                    total += int(f)
                    n += 1
            if n == 0:
                continue
            best = max(occ.values())
            modus = min(v for v, k in occ.items() if k == best)
            out[c] = (total / n, modus, n)
        return out


def host_rows(index: BigsiIndex, keys: np.ndarray, rpb_place: int) -> np.ndarray:
    """Row indices [N, H] for canonical k-mer byte rows [N, k], hashed on
    the host: the blocked placement with its build-time row group rpb_place
    for a blocked index, XXH3 rows for a classic one. int32, or int64 for a
    classic index past int32 row addressing (bloom_size >= 2^31)."""
    if index.blocked:
        from .ops.blocked import blocked_rows_host

        return blocked_rows_host(
            keys, index.num_hash, index.bloom_size, rpb_place,
            version=int(index.blocked),
        ).astype(np.int32)
    dt = np.int64 if index.bloom_size >= 2**31 else np.int32
    # the native row hasher emits uint32 rows: valid through 2^32; larger
    # blooms take the numpy uint64 path
    if keys.shape[0] and native.available() and index.bloom_size <= 2**32:
        rows = native.xxh3_rows(keys, index.num_hash, index.bloom_size)
    else:
        rows = bloom_rows_batch(keys, index.num_hash, index.bloom_size)
    return rows.astype(dt)


def flatten_keys(keys_per_read: list[np.ndarray], rows_of):
    """(rows [N, H], seg [N], pos [N]) of per-read k-mer byte rows given in
    set order, rows_of(keys) hashing them: seg is the read of each k-mer,
    pos its rank in the read's set. None when no read has a k-mer."""
    seg, pos, rows = [], [], []
    for i, keys in enumerate(keys_per_read):
        kn = keys.shape[0]
        if kn == 0:
            continue
        seg.append(np.full(kn, i, dtype=np.int32))
        pos.append(np.arange(kn, dtype=np.int32))
        rows.append(rows_of(keys))
    if not rows:
        return None
    return np.concatenate(rows), np.concatenate(seg), np.concatenate(pos)


class QueryEngine:
    """Executes the BIGSI hot loop on one device."""

    def __init__(
        self, index: BigsiIndex, chunk: int = 1 << 20,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.index = index
        self.chunk = chunk
        blocks, self.wpad = pack_matrix_blocks(np.asarray(index.matrix))
        # blocked (turbo) layout: one 512B block per k-mer (ops/blocked.py);
        # bv: 0 = classic rows, 1 = blocked, 2/3/4 = blocked split-lane
        # (the probe stream's layouts, ops/stream_query.py)
        self.bv = int(index.blocked)
        if self.bv and self.wpad > 128:
            raise ValueError(
                "blocked (turbo) layout holds a k-mer's rows in one 512B "
                "block and supports <= 4096 colors per device; use a classic "
                "index or shard colors across devices"
            )
        self.rpb = (128 // self.wpad) if self.bv else 0
        # shard-placed blocked indexes (build --color-shards): the placement
        # row group follows a color SHARD's packed width, not this engine's
        # full-width packing, so the single-device engine hashes on the host
        # with the recorded placement and gathers generically (the streams
        # of such an index run on the ("data", "color") mesh,
        # parallel/sharded.py::stream_batch_colorshard)
        self.rpb_place = index.place_rpb or self.rpb
        self._custom_place = self.rpb_place != self.rpb
        if self._custom_place:
            self.rpb = 0
        self.blocks2 = _i32(blocks).to(self.device)
        q = max(self.wpad // 128, 1)
        # rows of <= one block need only the row index to fit int32; wide
        # rows address bloom_size * q blocks. Past int32 row addressing the
        # engine takes the wide path: the host hashes int64 rows and the
        # generic gather's int64 word offsets take them as they are, which
        # keeps the reference's open usize bloom_size domain
        # (src/main.rs:475-477) up to the JAX package's 2^38 bits.
        self._wide = False
        if index.bloom_size * (q if self.wpad > 128 else 1) >= 2**31:
            if self.bv or self.wpad > 128:
                raise ValueError(
                    "bloom_size exceeds int32 device block addressing for "
                    "this layout; use a classic index (<= 4096 colors) or "
                    "shard colors/rows across devices"
                )
            if index.bloom_size * self.wpad >= 2**38:
                raise ValueError(
                    "bloom_size exceeds wide block addressing (2^38 bits); "
                    "shard rows across devices"
                )
            self._wide = True
        # wide rows multiply the epilogue's [chunk, wpad] footprint; cap the
        # scan chunk, the search_keys pad floor and the reads per read_id
        # dispatch so they stay memory-friendly
        if self.wpad > 128:
            self.chunk = min(self.chunk, max((1 << 29) // (self.wpad * 128), 2048))
            self._minpad = 2048
            self._rid_reads = 1024
        else:
            self._minpad = 16384
            self._rid_reads = 8192
        stream_on = os.environ.get("COLORID_STREAM", "1") != "0"
        self._stream = (
            self.bv in (2, 3, 4)  # split-lane placements
            and index.num_hash in STREAM_HASHES
            and self.wpad in STREAM_WPADS  # <= 1024 colors
            and not self._custom_place
            and stream_on
        )
        self._stream_classic = (
            self.bv == 0  # reference-placement (classic) rows
            and self.wpad == 1  # <= 32 colors (wider rows: generic gather)
            and index.bloom_size < 2**31  # int32 rows (a wide index scans)
            and stream_on
        )

    def _use_stream(self, seg_kmers: int) -> bool:
        """Blocked probe stream (default on for eligible blocked v2/v3/v4
        indexes): used when a segment's probes are dense relative to the
        matrix (each 128-block tile touched by many probes); sparse
        segments keep the generic block gather. COLORID_STREAM=force
        streams every segment (testing); =0 disables."""
        if not self._stream:
            return False
        if os.environ.get("COLORID_STREAM") == "force":
            return True
        n_blocks = self.index.bloom_size // self.rpb
        return seg_kmers >= 4 * n_blocks

    def _use_stream_classic(self, n_kmers: int, k: int | None) -> bool:
        """Classic sorted-row stream: pays off when the H*N row probes are
        dense relative to the matrix blocks (a PC_CL-probe chunk must span
        <= the kernel's 2-tile window, so >= ~16 probes/block); sparse
        queries keep the generic gather. COLORID_STREAM=force streams every
        eligible query (testing); =0 disables."""
        if not self._stream_classic or not (k and 4 <= k <= 32):
            return False
        if os.environ.get("COLORID_STREAM") == "force":
            return True
        from .ops.stream_query import NT_CL, PC_CL, T

        n_blocks = self.blocks2.shape[0]
        span = NT_CL * T  # the kernel's window, in blocks
        return n_kmers * self.index.num_hash >= (PC_CL // span) * n_blocks

    # -- hashing ------------------------------------------------------------

    def rows_for_keys(self, keys: np.ndarray) -> np.ndarray:
        """Row indices [N, H] for canonical k-mer byte rows [N, k]: XXH3
        rows (int64 on a wide index, else int32), or the blocked placement
        of a blocked index."""
        return host_rows(self.index, keys, self.rpb_place)

    # -- search (batch_search_pe / perfect_search hot loop) ------------------

    def _new_accumulators(self, capO: int):
        return new_accumulators(self.index.n_colors, self.wpad, capO, self.device)

    def search_keys(
        self,
        keys: np.ndarray | None,
        qcounts: np.ndarray | None = None,
        rows_all: np.ndarray | None = None,
        packed_all: np.ndarray | None = None,
        k: int | None = None,
    ) -> SearchResult:
        """Per-color counts + uniq-hit coverage stats for a set of k-mers.

        Inputs, most to least preferred: ``packed_all`` [N, 2] uint32 2-bit
        packed k-mers (+ k) hash on device; ``keys`` ASCII rows pack
        host-side when eligible; ``rows_all`` precomputed row indices skip
        hashing entirely. The whole query accumulates on device; the host
        fetches once at the end."""
        if packed_all is not None:
            n = packed_all.shape[0]
        elif rows_all is not None:
            n = rows_all.shape[0]
        else:
            n = keys.shape[0]
        C = self.index.n_colors
        if n == 0:
            return self._empty_result()
        dev_hash = self.index.bloom_size < 2**31 and not self._custom_place
        if packed_all is not None and not (k and 4 <= k <= 32 and dev_hash):
            # device hash envelope exceeded: fall back to host hashing
            packed_all = None
            if keys is None and rows_all is None:
                raise ValueError(
                    "packed_all is outside the device-hash envelope "
                    f"(k={k}, bloom_size={self.index.bloom_size}; need "
                    "4 <= k <= 32, bloom_size < 2^31 and an index that is "
                    "not shard-placed) and no keys/rows were given to hash "
                    "host-side"
                )
        if packed_all is None and rows_all is None:
            k = keys.shape[1]
            if 4 <= k <= 32 and dev_hash:
                packed_all = pack_keys_host(keys)
            if packed_all is None:
                rows_all = self.rows_for_keys(keys)
        if qcounts is None:
            qcounts = np.ones(n, dtype=np.int32)
        qcounts = np.asarray(qcounts, dtype=np.int32)
        if packed_all is not None and self._use_stream_classic(n, k):
            res = self._search_keys_classic_stream(packed_all, qcounts, k)
            if res is not None:
                return res
        capO = _round_up(n, 1024)
        stats, hist, oc_buf, of_buf = self._new_accumulators(capO)
        # one pass per segment; a segment scans fixed-size chunks, or goes
        # through the blocked probe stream when it is dense enough
        chunk = min(self.chunk, 1 << 20)
        seg = chunk * 8
        qc_all = np.minimum(np.maximum(qcounts, 1), 65535).astype(np.int32)
        geo = dict(
            wpad=self.wpad, num_hash=self.index.num_hash,
            bloom_size=self.index.bloom_size, rpb=self.rpb,
        )
        drops: list[torch.Tensor] = []
        for start in range(0, n, seg):
            stop = min(start + seg, n)
            m = stop - start
            if packed_all is not None and self._use_stream(m):
                from .ops.stream_query import stream_accumulate_hash

                size = _round_up(m, chunk if m > chunk else min(self._minpad, chunk))
                pk = np.zeros((size, 2), dtype=np.uint32)
                pk[:m] = packed_all[start:stop]
                qc = np.zeros(size, dtype=np.int32)  # 0 marks padding
                qc[:m] = qc_all[start:stop]
                *_, nd = stream_accumulate_hash(
                    stats, hist, oc_buf, of_buf, self.blocks2,
                    _i32(pk).to(self.device), _i32(qc).to(self.device), start,
                    k=k, n_colors=C, bv=self.bv, **geo,
                )
                drops.append(nd)
            elif packed_all is not None:
                query_accumulate_hash_scan(
                    stats, hist, oc_buf, of_buf, self.blocks2,
                    _i32(packed_all[start:stop]).to(self.device),
                    _i32(qc_all[start:stop]).to(self.device), start,
                    chunk=chunk, k=k, bv=self.bv or 1, **geo,
                )
            else:
                query_accumulate_scan(
                    stats, hist, oc_buf, of_buf, self.blocks2,
                    torch.from_numpy(
                        rows_all[start:stop].astype(np.int64 if self._wide else np.int32)
                    ).to(self.device),
                    torch.ones(m, dtype=torch.bool, device=self.device),
                    _i32(qc_all[start:stop]).to(self.device), start,
                    wpad=self.wpad, chunk=chunk, rpb=self.rpb,
                )
        if drops and int(torch.stack(drops).sum()) > 0:
            # probe-stream residual/overflow capacity exceeded (requires a
            # pathological probe distribution): rerun on the generic path
            self._stream = False
            try:
                return self.search_keys(keys, qcounts, rows_all, packed_all, k)
            finally:
                self._stream = True
        return self._collect(stats, hist, oc_buf, of_buf, capO, qcounts)

    def search_keys_dev(
        self, pk_dev: torch.Tensor, qc_dev: torch.Tensor, k: int,
        max_freq: int | None = None,
    ) -> SearchResult | None:
        """search_keys over a device-resident, pre-padded query batch on a
        stream-eligible blocked index: one exact-mode probe-stream dispatch
        and one fetch. None if the stream's residual/overflow capacity was
        exceeded or ``max_freq`` did not hold (rerun through
        search_keys_dev_generic_async or the host path)."""
        return self._finish_dev(
            self.search_keys_dev_async(pk_dev, qc_dev, k=k, max_freq=max_freq)
        )

    def _check_dev_hash(self, k: int):
        # the device hash's rows are int32 (ops/hash_torch.py)
        if not (4 <= k <= 32 and self.index.bloom_size < 2**31):
            raise ValueError(
                "device hashing needs 4 <= k <= 32 and bloom_size < 2^31"
            )

    def _check_dev_batch(self, name: str, pk_dev, qc_dev, k: int, unit: int):
        self._check_dev_hash(k)
        if self._custom_place:
            raise ValueError(
                f"{name}: device hashing does not cover shard-placed indexes "
                "on one device; use ShardedQueryEngine or search_keys"
            )
        if pk_dev.dtype != torch.int32 or qc_dev.dtype != torch.int32:
            raise ValueError(
                f"{name} expects int32 packed k-mers and int32 frequencies "
                f"(0 = pad); got {pk_dev.dtype}/{qc_dev.dtype}"
            )
        if pk_dev.shape[0] % unit:
            raise ValueError(f"P must be a multiple of {unit}")

    def search_keys_dev_async(
        self, pk_dev: torch.Tensor, qc_dev: torch.Tensor, k: int,
        max_freq: int | None = None,
    ):
        """Dispatch half of search_keys_dev. pk_dev int32 [P, 2] (bit view
        of the uint32 packed k-mers), qc_dev int32 [P] full frequencies
        (0 = pad), P a multiple of the stream chunk (ops/stream_query.PC).
        Returns (vec, oc_buf, of_buf, capO) with vec = cat([stats, n_drop,
        hist.ravel()]) still on the device, so callers can queue several
        dispatches before one fetch; decode with search_keys_dev_finish.

        max_freq: optional UPPER BOUND on the batch's frequencies (hosts
        that counted the k-mers know it for free). When it fits the sort
        key's low bits the sort drops its frequency payload
        (ops/stream_query.QKEY_BITS). The bound is checked on the device:
        a batch that exceeds it reports n_drop > 0 and decodes to None."""
        from .ops.stream_query import (
            OVER_CAP, PC, QKEY_MASK, RES_CAP, stream_accumulate_hash_exact,
        )

        if not self._stream:
            raise ValueError("search_keys_dev requires a stream-eligible index")
        self._check_dev_batch("search_keys_dev", pk_dev, qc_dev, k, PC)
        capO = OVER_CAP + RES_CAP  # both appenders are capped (stream_query)
        stats, hist, oc_buf, of_buf = self._new_accumulators(capO)
        *_, nd = stream_accumulate_hash_exact(
            stats, hist, oc_buf, of_buf, self.blocks2, pk_dev, qc_dev,
            wpad=self.wpad, k=k, num_hash=self.index.num_hash,
            bloom_size=self.index.bloom_size, rpb=self.rpb,
            n_colors=self.index.n_colors, bv=self.bv,
            qc_in_key=max_freq is not None and 0 < max_freq <= QKEY_MASK,
        )
        if max_freq is not None:
            nd = nd + (qc_dev.max() > max_freq).to(nd.dtype)
        return _dev_vec(stats, nd, hist), oc_buf, of_buf, capO

    def search_keys_dev_generic_async(
        self, pk_dev: torch.Tensor, qc_dev: torch.Tensor, k: int,
        capO: int = 1 << 18,
    ):
        """Device-resident exact-mode query through the GENERIC gather:
        works on every layout. Same contract as search_keys_dev_async
        (decode with search_keys_dev_finish). P may be any length (the
        last chunk is short); qc_dev are full int32 frequencies with 0 =
        pad. capO bounds the overflow list the result can report."""
        chunk = min(self.chunk, 1 << 20)
        self._check_dev_batch("search_keys_dev_generic", pk_dev, qc_dev, k, 1)
        stats, hist, oc_buf, of_buf = self._new_accumulators(capO)
        query_accumulate_hash_scan_exact(
            stats, hist, oc_buf, of_buf, self.blocks2, pk_dev, qc_dev,
            wpad=self.wpad, chunk=chunk, k=k, num_hash=self.index.num_hash,
            bloom_size=self.index.bloom_size, rpb=self.rpb, bv=self.bv or 1,
        )
        nd = torch.zeros(1, dtype=torch.int32, device=self.device)
        return _dev_vec(stats, nd, hist), oc_buf, of_buf, capO

    def _search_keys_classic_stream(
        self, packed_all: np.ndarray, qcounts: np.ndarray, k: int
    ) -> SearchResult | None:
        """Whole-batch classic sorted-row stream (host arrays in, one fetch).
        None when the kernel's residual capacity was exceeded, so
        search_keys falls through to the generic gather."""
        from .ops.stream_query import EPC_CL

        n = packed_all.shape[0]
        P0 = _round_up(n, EPC_CL)
        pk = np.zeros((P0, 2), dtype=np.uint32)
        pk[:n] = packed_all
        qc = np.zeros(P0, dtype=np.int32)
        qc[:n] = np.maximum(qcounts[:n], 1)
        return self._finish_dev(self.search_keys_dev_classic_async(
            _i32(pk).to(self.device), _i32(qc).to(self.device), k,
            capO=_round_up(n, 1024),
        ))

    def search_keys_dev_classic_async(
        self, pk_dev: torch.Tensor, qc_dev: torch.Tensor, k: int,
        capO: int | None = None,
    ):
        """Device-resident classic sorted-row-stream dispatch. pk_dev int32
        [P0, 2] (bit view of the uint32 packed k-mers), qc_dev int32 [P0]
        full frequencies (0 = pad), P0 a multiple of EPC_CL. Returns (vec,
        oc_buf, of_buf, capO) with vec = cat([stats, n_drop, hist.ravel()])
        still on the device, so callers can queue several dispatches before
        one fetch; decode with search_keys_dev_finish (None = residual
        capacity tripped: re-run through the generic path)."""
        from .ops.stream_query import EPC_CL, stream_accumulate_classic_exact

        if not self._stream_classic:
            raise ValueError(
                "search_keys_dev_classic requires a classic wpad==1 index"
            )
        self._check_dev_batch("search_keys_dev_classic", pk_dev, qc_dev, k, EPC_CL)
        if capO is None:
            capO = _round_up(pk_dev.shape[0], 1024)
        stats, hist, oc_buf, of_buf = self._new_accumulators(capO)
        *_, nd = stream_accumulate_classic_exact(
            stats, hist, oc_buf, of_buf, self.blocks2, pk_dev, qc_dev,
            wpad=self.wpad, k=k, num_hash=self.index.num_hash,
            bloom_size=self.index.bloom_size, n_colors=self.index.n_colors,
        )
        return _dev_vec(stats, nd, hist), oc_buf, of_buf, capO

    def search_keys_dev_finish(
        self, host: np.ndarray, oc_buf, of_buf, capO
    ) -> SearchResult | None:
        """Decode a fetched search_keys_dev_async / _generic_async /
        _classic_async vector (numpy) into a SearchResult; None when the
        drop guard tripped. Exact mode: the overflow list carries
        frequencies directly."""
        C = self.index.n_colors
        sl = C + self.wpad + 2
        if int(host[sl]) > 0:  # capacity exceeded: generic path rerun
            return None
        hist = host[sl + 1 :].reshape(C, FREQ_CAP)
        return self._result(host[:sl], hist, oc_buf, of_buf, capO, None)

    def _finish_dev(self, out) -> SearchResult | None:
        """Fetch and decode one search_keys_dev*_async dispatch."""
        vec, oc_buf, of_buf, capO = out
        return self.search_keys_dev_finish(vec.cpu().numpy(), oc_buf, of_buf, capO)

    def _collect(self, stats, hist, oc_buf, of_buf, capO, qcounts=None):
        """Fetch the device accumulators into a SearchResult. With a host
        ``qcounts`` copy, overflow slots hold global k-mer indices resolved
        against it; without one they hold the exact frequency directly."""
        return self._result(
            stats.cpu().numpy(), hist.cpu().numpy(), oc_buf, of_buf, capO,
            qcounts,
        )

    def _result(self, st, hist_np, oc_buf, of_buf, capO, qcounts):
        C = self.index.n_colors
        W = self.index.words_per_row
        counts = st[:C].astype(np.int64)
        and_all = st[C : C + W].view(np.uint32).copy()
        all_valid = bool(st[C + self.wpad])
        n_over = int(st[C + self.wpad + 1])
        none = np.zeros(0, dtype=np.int32)
        if n_over:
            kp = min(n_over, capO)
            over_c = oc_buf[:kp].cpu().numpy()
            over_v = of_buf[:kp].cpu().numpy()
            if qcounts is not None:
                over_f = qcounts[over_v].astype(np.int32)
            else:
                over_f = over_v.astype(np.int32)
        else:
            over_c = over_f = none
        return SearchResult(
            counts, all_valid, and_all, hist_np.astype(np.int64), over_c, over_f
        )

    def _empty_result(self) -> SearchResult:
        """The SearchResult of a query without k-mers."""
        C = self.index.n_colors
        none = np.zeros(0, dtype=np.int32)
        return SearchResult(
            np.zeros(C, dtype=np.int64), True,
            np.full(self.index.words_per_row, 0xFFFFFFFF, dtype=np.uint32),
            np.zeros((C, FREQ_CAP), dtype=np.int64), none, none,
        )

    def _to_dev(self, a) -> torch.Tensor:
        """A host array (numpy; uint32 words as their int32 bit view) or a
        tensor, on this engine's device. On the card a host array goes
        through pinned memory with a non-blocking copy, so queueing several
        dispatches never waits for the ones before."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -- device k-mer extraction (ops/extract.py) ----------------------------

    def search_reads(
        self,
        reads_packed,  # uint32 [R, ceil(L/16)] 2-bit read words (or a tensor)
        lens,  # int32 [R] true read lengths
        valid_bits=None,  # uint32 [R, ceil(L/32)]
        *,
        k: int,
        L: int,
        filter_t: int = 0,
        d: int = 1,
    ) -> tuple[SearchResult, int]:
        """Search a batch of uppercase-ACGT reads shipped as 2-bit words.

        The device extracts canonical k-mer windows, counts them, applies
        the strictly-greater frequency filter (kmer.rs:826-837) and queries
        the index, all without the k-mers ever existing host-side
        (ops/extract.py): the host link carries ~0.27 bytes per read base
        instead of 10 bytes per unique k-mer. Inputs may already be on the
        device (tensors, int32 bit views). Returns (result, n_unique
        filtered k-mers). N/other invalid bases are handled exactly via the
        optional per-base validity bitplane (pack_reads_valid): windows
        touching one are skipped like the reference's has_no_n check;
        lowercase-containing reads still need the exact host path (raw-byte
        canonical order is not 2-bit representable).

        A value-addressed (v3/v4) stream-eligible index answers through the
        fused pipeline (ops/fused_reads.py), as the JAX package does: one
        dispatch up to COLORID_FUSED_MAX_WINDOWS windows (read per call,
        default 28,000,000), the chunked pipeline beyond. A capacity trip
        there (n_drop > 0), and every other index, take the counted route
        (_search_reads_counted).
        """
        if not (4 <= k <= 32 and self.index.bloom_size < 2**31):
            raise ValueError("search_reads requires the device-hash envelope")
        if self._custom_place:
            raise ValueError(
                "search_reads device hashing does not cover shard-placed "
                "indexes on one device; use the sharded engine or search_keys"
            )
        n_windows = reads_packed.shape[0] * (L - k + 1)
        if n_windows >= 2**31:
            raise ValueError(
                f"read batch spans {n_windows} k-mer windows, beyond int32 "
                "device indexing; split the batch (R * (L - k + 1) must stay "
                "under 2^31)"
            )
        if not isinstance(lens, torch.Tensor):
            lens = np.asarray(lens, dtype=np.int32)
        reads_d, lens_d = self._to_dev(reads_packed), self._to_dev(lens)
        vb_d = None if valid_bits is None else self._to_dev(valid_bits)
        if n_windows > 0 and self._stream and self.bv in (3, 4):
            max_w = int(os.environ.get("COLORID_FUSED_MAX_WINDOWS", 28_000_000))
            if n_windows > max_w:
                out = self._search_reads_fused_chunked(
                    reads_d, lens_d, vb_d, k=k, L=L, filter_t=filter_t, d=d,
                    max_windows=max_w,
                )
            else:
                out = self._search_reads_fused(
                    reads_d, lens_d, vb_d, k=k, L=L, filter_t=filter_t, d=d,
                )
            if out is not None:
                return out
        return self._search_reads_counted(
            reads_d, lens_d, vb_d, k=k, L=L, filter_t=filter_t, d=d
        )

    def _search_reads_counted(
        self, reads_d, lens_d, vb_d, *, k, L, filter_t, d
    ) -> tuple[SearchResult, int]:
        """search_reads through extract_count: the counted k-mers stay on
        the device and go to the dispatcher search_keys would choose for a
        batch of that size: the blocked probe stream (search_keys_dev_async)
        or the classic sorted-row stream (search_keys_dev_classic_async)
        when the batch is dense enough, else the generic gather, which also
        reruns a stream dispatch whose capacity was exceeded. The JAX
        package answers these indexes through the generic gather: counts,
        all_valid, and_all, freq_stats() and n_unique agree with it, the
        overflow list as a multiset."""
        from .ops.extract import extract_count
        from .ops.stream_query import EPC_CL, PC

        pk, qc, n_u = extract_count(
            reads_d, lens_d, vb_d, k=k, L=L, filter_t=filter_t, d=d
        )
        if qc.numel() == 0:
            return self._empty_result(), 0
        # one fetch of two scalars; keys and counts stay on the device
        n, max_freq = torch.stack([n_u, qc.max()]).tolist()
        if n == 0:
            return self._empty_result(), 0
        pk, qc = pk[:n], qc[:n]
        capO = _round_up(n, 1024)
        res = None
        if self._use_stream(n):
            res = self._finish_dev(self.search_keys_dev_async(
                *_pad_rows(pk, qc, PC), k=k, max_freq=max_freq
            ))
        elif self._use_stream_classic(n, k):
            res = self._finish_dev(self.search_keys_dev_classic_async(
                *_pad_rows(pk, qc, EPC_CL), k, capO=capO
            ))
        if res is None:  # sparse batch, or a stream's capacity exceeded
            res = self._finish_dev(
                self.search_keys_dev_generic_async(pk, qc, k, capO=capO)
            )
        return res, n

    # -- the fused reads path (ops/fused_reads.py) ----------------------------

    def _fused_geometry(self) -> dict:
        return dict(
            wpad=self.wpad, num_hash=self.index.num_hash,
            bloom_size=self.index.bloom_size, rpb=self.rpb,
            n_colors=self.index.n_colors, bv=self.bv,
        )

    def _search_reads_fused(
        self, reads_d, lens_d, vb_d=None, *, k, L, filter_t, d
    ) -> tuple[SearchResult, int] | None:
        """search_reads through the single fused dispatch: extraction, exact
        counting and the probe stream in one call. None when the stream's
        residual/overflow capacity was exceeded, so the caller falls back
        to the counted route."""
        return self._fused_finish(self.search_reads_fused_async(
            reads_d, lens_d, vb_d, k=k, L=L, filter_t=filter_t, d=d
        ))

    def _search_reads_fused_chunked(
        self, reads_d, lens_d, vb_d=None, *, k, L, filter_t, d, max_windows,
    ) -> tuple[SearchResult, int] | None:
        """The chunked fused pipeline (ops/fused_reads.py dispatches A, A2,
        B): no dispatch spans more than ~max_windows k-mer windows.
        Per-chunk extract + sort + count, a compaction sized from the
        largest per-chunk unique count (one fetch), then one merge + global
        filter + probe stream."""
        from .ops.fused_reads import (
            compact_sorted,
            extract_sorted_counts,
            fused_merge_query,
        )
        from .ops.stream_query import OVER_CAP, RES_CAP

        NW = L - k + 1
        R = reads_d.shape[0]
        Rc = max(max_windows // NW, 1)
        S = -(-R // Rc)
        Rc = -(-R // S)  # balanced chunks
        padR = S * Rc - R
        if padR:  # zero-length reads: no valid window
            reads_d = torch.cat([reads_d, reads_d.new_zeros((padR, reads_d.shape[1]))])
            lens_d = torch.cat([lens_d, lens_d.new_zeros(padR)])
            if vb_d is not None:
                vb_d = torch.cat([vb_d, vb_d.new_zeros((padR, vb_d.shape[1]))])
        outs = [
            extract_sorted_counts(
                reads_d[s * Rc : (s + 1) * Rc], lens_d[s * Rc : (s + 1) * Rc],
                None if vb_d is None else vb_d[s * Rc : (s + 1) * Rc],
                k=k, L=L, d=d,
            )
            for s in range(S)
        ]
        n_max = int(torch.stack([o[2] for o in outs]).max())
        # the JAX package's cap: a power of two of at least 2^20 (its
        # compile-shape bound), which fixes the merge's probe stream
        cap = min(1 << max(20, max(n_max, 1).bit_length()), Rc * NW)
        comps = [compact_sorted(o[0], o[1], cap=cap) for o in outs]
        capO = OVER_CAP + RES_CAP
        stats, hist, oc_buf, of_buf = self._new_accumulators(capO)
        *_, n_drop, n_u = fused_merge_query(
            stats, hist, oc_buf, of_buf, self.blocks2,
            torch.stack([c[0] for c in comps]),
            torch.stack([c[1] for c in comps]),
            k=k, filter_t=filter_t, **self._fused_geometry(),
        )
        return self._fused_finish(
            (_dev_vec(stats, n_drop, hist, n_u), oc_buf, of_buf, capO)
        )

    def search_reads_fused_async(
        self, reads_dev, lens_dev, valid_bits=None, *,
        k: int, L: int, filter_t: int = 0, d: int = 1,
    ):
        """Dispatch half of the single fused reads search: returns (vec,
        oc_buf, of_buf, capO) with vec = cat([stats, n_drop, n_unique,
        hist.ravel()]) still on the device, so callers can queue several
        dispatches and fetch them in one stacked copy; decode with
        search_reads_fused_finish. Raises ValueError when the single fused
        dispatch is not eligible (a layout that is not value-addressed, the
        device-hash envelope, or a window count past
        COLORID_FUSED_MAX_WINDOWS): callers fall back to search_reads."""
        from .ops.fused_reads import fused_search_reads
        from .ops.stream_query import OVER_CAP, RES_CAP

        if not (4 <= k <= 32 and self.index.bloom_size < 2**31):
            raise ValueError("fused async requires the device-hash envelope")
        if self._custom_place or not (self._stream and self.bv in (3, 4)):
            raise ValueError(
                "fused async requires a stream-eligible value-addressed "
                "(v3/v4) blocked index"
            )
        n_windows = reads_dev.shape[0] * (L - k + 1)
        max_w = int(os.environ.get("COLORID_FUSED_MAX_WINDOWS", 28_000_000))
        if n_windows > max_w:
            raise ValueError(
                f"{n_windows} windows exceeds the single-dispatch guard "
                f"({max_w}); use search_reads (chunked pipeline)"
            )
        if not isinstance(lens_dev, torch.Tensor):
            lens_dev = np.asarray(lens_dev, dtype=np.int32)
        capO = OVER_CAP + RES_CAP
        stats, hist, oc_buf, of_buf = self._new_accumulators(capO)
        *_, n_drop, n_u = fused_search_reads(
            stats, hist, oc_buf, of_buf, self.blocks2,
            self._to_dev(reads_dev), self._to_dev(lens_dev),
            None if valid_bits is None else self._to_dev(valid_bits),
            k=k, L=L, filter_t=filter_t, d=d, **self._fused_geometry(),
        )
        return _dev_vec(stats, n_drop, hist, n_u), oc_buf, of_buf, capO

    def search_reads_fused_finish(
        self, host, oc_buf, of_buf, capO
    ) -> tuple[SearchResult, int] | None:
        """Decode a fetched search_reads_fused_async vector (numpy) into
        (SearchResult, n_unique); None when the drop guard tripped."""
        return self._fused_decode(np.asarray(host), oc_buf, of_buf, capO)

    def _fused_finish(self, out) -> tuple[SearchResult, int] | None:
        """Fetch (ONE copy for everything but the rare overflow list) and
        decode one fused dispatch's (vec, oc_buf, of_buf, capO)."""
        vec, oc_buf, of_buf, capO = out
        return self._fused_decode(vec.cpu().numpy(), oc_buf, of_buf, capO)

    def _fused_decode(
        self, host, oc_buf, of_buf, capO
    ) -> tuple[SearchResult, int] | None:
        C = self.index.n_colors
        sl = C + self.wpad + 2
        if int(host[sl]) > 0:  # n_drop: capacity exceeded, caller falls back
            return None
        hist = host[sl + 2 :].reshape(C, FREQ_CAP)
        res = self._result(host[:sl], hist, oc_buf, of_buf, capO, None)
        return res, int(host[sl + 1])

    def count_reads_histogram(
        self,
        reads_packed,
        lens,
        valid_bits=None,
        *,
        k: int,
        L: int,
        d: int = 1,
        cap: int = 65536,
    ) -> np.ndarray:
        """Device-side per-unique-k-mer count histogram (auto_cutoff input;
        kmer.rs:866): one [cap] int32 fetch instead of shipping counts."""
        from .ops.extract import count_histogram

        if not isinstance(lens, torch.Tensor):
            lens = np.asarray(lens, dtype=np.int32)
        return count_histogram(
            self._to_dev(reads_packed), self._to_dev(lens),
            None if valid_bits is None else self._to_dev(valid_bits),
            k=k, L=L, d=d, cap=cap,
        ).cpu().numpy()

    # -- read classifier (read_id hot loop) ----------------------------------
    #
    # Each method cuts its batch into chunks of _rid_reads reads, queues
    # every chunk's dispatch, and fetches all of them at once at the end
    # (the *_async variants return that fetch as a closure). Chunks are not
    # padded: without a compiler cache, fixed shapes buy nothing here.

    def _rid_chunks(self, n_reads: int, seg: np.ndarray | None = None):
        """(r0, r1, lo, hi) per chunk of reads: reads [r0, r1) own the
        entries [lo, hi) of the read-sorted ``seg`` (None: one entry per
        read)."""
        for r0 in range(0, n_reads, self._rid_reads):
            r1 = min(r0 + self._rid_reads, n_reads)
            if seg is None:
                yield r0, r1, r0, r1
            else:
                lo, hi = np.searchsorted(seg, [r0, r1], "left")
                yield r0, r1, int(lo), int(hi)

    @staticmethod
    def _fetch(out: np.ndarray, pending: list):
        """One device-to-host copy of every queued chunk's rows into out."""
        if pending:
            host = torch.cat([rep for _r0, _r1, rep in pending]).cpu().numpy()
            j = 0
            for r0, r1, _rep in pending:
                out[r0:r1] = host[j : j + r1 - r0]
                j += r1 - r0
        return out

    def _flatten_keys(self, keys_per_read: list[np.ndarray]):
        return flatten_keys(keys_per_read, self.rows_for_keys)

    def readid_counts(
        self,
        keys_per_read: list[np.ndarray],
        start_sample: int,
    ) -> np.ndarray:
        """Per-read per-color hit counts [B, C+1] (column C = no_hits),
        replicating search_index(_classic) semantics including the
        break-on-absent quirk and the -B candidate-set two-phase count."""
        n_reads = len(keys_per_read)
        flat = self._flatten_keys(keys_per_read)
        if flat is None:
            return np.zeros((n_reads, self.index.n_colors + 1), dtype=np.int32)
        return self.readid_counts_arrays(*flat, n_reads, start_sample)

    def readid_firsthit(
        self,
        keys_per_read: list[np.ndarray],
        start_sample: int,
    ) -> np.ndarray:
        """First-hit position matrix [B, C+1] (column C = first-absent
        position; 2**30 = never) for keys given in set-iteration order:
        recovers the reference's final_report insertion order for the
        read_id tie-order fixup. Callers pass only the (rare) tied reads."""
        from .ops.query import BIG, query_readid_firsthit

        C = self.index.n_colors
        n_reads = len(keys_per_read)
        out = np.full((n_reads, C + 1), BIG, dtype=np.int32)
        flat = self._flatten_keys(keys_per_read)
        if flat is None:
            return out
        rows, seg, pos = (self._to_dev(a) for a in flat)
        rep = query_readid_firsthit(
            self.blocks2, rows, seg, pos, num_reads=n_reads,
            start_sample=start_sample, num_colors=C, wpad=self.wpad,
            rpb=self.rpb,
        )
        out[:] = rep.cpu().numpy()
        return out

    def _reads_geometry(self, k: int, L: int) -> dict:
        self._check_dev_hash(k)
        return dict(
            num_colors=self.index.n_colors, wpad=self.wpad, k=k, L=L,
            num_hash=self.index.num_hash, bloom_size=self.index.bloom_size,
            rpb=self.rpb, bv=self.bv or 1,
        )

    def _reads_chunk(self, mates_packed, mate_seg, lens, ranks, r0, lo, hi):
        """One chunk of the reads path on the device: its mates, their read
        ids relative to r0 (int16), lengths and rank plane."""
        return (
            self._to_dev(mates_packed[lo:hi]),
            self._to_dev((mate_seg[lo:hi] - r0).astype(np.int16)),
            self._to_dev(np.asarray(lens[lo:hi], dtype=np.int32)),
            self._to_dev(ranks[lo:hi]),
        )

    def readid_firsthit_reads(
        self,
        mates_packed: np.ndarray,
        mate_seg: np.ndarray,
        lens: np.ndarray,
        ranks: np.ndarray,
        n_reads: int,
        start_sample: int,
        k: int,
        L: int,
    ) -> np.ndarray:
        """readid_firsthit from 2-bit packed mates + the per-window rank
        plane (no host k-mer work; the tie-fixup path for reads-path
        groups). Same [B, C+1] contract as readid_firsthit."""
        return self.readid_firsthit_reads_async(
            mates_packed, mate_seg, lens, ranks, n_reads, start_sample, k, L
        )()

    def readid_firsthit_reads_async(
        self,
        mates_packed: np.ndarray,
        mate_seg: np.ndarray,
        lens: np.ndarray,
        ranks: np.ndarray,
        n_reads: int,
        start_sample: int,
        k: int,
        L: int,
    ):
        """readid_firsthit_reads with a deferred fetch (dispatch now, the
        returned callable produces the matrix) so the classifier overlaps
        the tie-fixup round trip with other host work."""
        from .ops.query import BIG, query_readid_firsthit_reads

        out = np.full((n_reads, self.index.n_colors + 1), BIG, dtype=np.int32)
        M = mates_packed.shape[0]
        if M == 0:
            return lambda: out
        rep = query_readid_firsthit_reads(
            self.blocks2,
            *self._reads_chunk(mates_packed, np.asarray(mate_seg, dtype=np.int32),
                               lens, ranks, 0, 0, M),
            num_reads=n_reads, start_sample=start_sample,
            **self._reads_geometry(k, L),
        )
        return lambda: self._fetch(out, [(0, n_reads, rep)])

    def readid_counts_packed(
        self,
        packed: np.ndarray,  # uint32 [N, 2]
        seg: np.ndarray,  # int16 [N] sorted asc
        pos: np.ndarray,  # int16 [N]
        n_reads: int,
        start_sample: int,
        k: int,
    ) -> np.ndarray:
        """readid counts with device hashing (12 B per k-mer of host
        traffic)."""
        from .ops.query import query_readid_hash_batch

        self._check_dev_hash(k)
        out = np.zeros((n_reads, self.index.n_colors + 1), dtype=np.int32)
        pending = []
        for r0, r1, lo, hi in self._rid_chunks(n_reads, seg):
            if hi == lo:
                continue
            rep = query_readid_hash_batch(
                self.blocks2,
                self._to_dev(packed[lo:hi]),
                self._to_dev((seg[lo:hi] - r0).astype(np.int16)),
                self._to_dev(np.asarray(pos[lo:hi], dtype=np.int16)),
                num_reads=r1 - r0, start_sample=start_sample,
                num_colors=self.index.n_colors, wpad=self.wpad, k=k,
                num_hash=self.index.num_hash,
                bloom_size=self.index.bloom_size, rpb=self.rpb,
                bv=self.bv or 1,
            )
            pending.append((r0, r1, rep))
        return self._fetch(out, pending)

    def readid_counts_reads(
        self,
        mates_packed: np.ndarray,  # uint32 [M, ceil(L/16)]
        mate_seg: np.ndarray,  # int16/int32 [M] read id per mate, sorted asc
        lens: np.ndarray,  # int32 [M]
        ranks: np.ndarray,  # int16 or uint8 [M, L-k+1]
        n_reads: int,
        start_sample: int,
        k: int,
        L: int,
    ) -> np.ndarray:
        """readid counts with device-side window extraction: the host ships
        2-bit packed mates + the per-window rank plane (~2.3 B/window)
        instead of 12 B per unique k-mer. Same [B, C+1] contract as
        readid_counts."""
        return self.readid_counts_reads_async(
            mates_packed, mate_seg, lens, ranks, n_reads, start_sample, k, L
        )()

    def readid_counts_reads_async(
        self,
        mates_packed: np.ndarray,
        mate_seg: np.ndarray,
        lens: np.ndarray,
        ranks: np.ndarray,
        n_reads: int,
        start_sample: int,
        k: int,
        L: int,
    ):
        """readid_counts_reads with a deferred fetch: all chunks dispatch
        now and the returned zero-arg callable produces the [B, C+1] matrix,
        so the classifier overlaps the device round trip with host work
        (decision math, tie preparation)."""
        from .ops.query import query_readid_reads_batch

        out = np.zeros((n_reads, self.index.n_colors + 1), dtype=np.int32)
        mate_seg = np.asarray(mate_seg, dtype=np.int32)
        pending = []
        for r0, r1, lo, hi in self._rid_chunks(n_reads, mate_seg):
            if hi == lo:
                continue
            rep = query_readid_reads_batch(
                self.blocks2,
                *self._reads_chunk(mates_packed, mate_seg, lens, ranks, r0, lo, hi),
                num_reads=r1 - r0, start_sample=start_sample,
                **self._reads_geometry(k, L),
            )
            pending.append((r0, r1, rep))
        return lambda: self._fetch(out, pending)

    def readid_counts_orderfree(
        self,
        mates_packed: np.ndarray,  # uint32 [M, ceil(L/16)]; M = n_reads*nm
        lens: np.ndarray,  # int32 [M]
        valid_bits: np.ndarray,  # uint32 [M, ceil(L/32)]
        n_reads: int,
        nm: int,
        k: int,
        L: int,
        d: int = 1,
    ) -> np.ndarray:
        """Order-free read classifier pass (ops/query.py::
        query_readid_orderfree_reads): the device dedups each read's
        canonical k-mer set itself, so the host ships ONLY packed mates, no
        hashbrown rank plane. Returns int32 [n_reads, C+3] (full counts,
        any-absent flag, distinct-k-mer count, zero-hit-k-mer count);
        pipelines/read_id.py decides which reads still need the exact
        set-order replay."""
        from .ops.query import query_readid_orderfree_reads

        geo = self._reads_geometry(k, L)
        out = np.zeros((n_reads, geo["num_colors"] + 3), dtype=np.int32)
        pending = []
        for r0, r1, _lo, _hi in self._rid_chunks(n_reads):
            m0, m1 = r0 * nm, r1 * nm
            rep = query_readid_orderfree_reads(
                self.blocks2,
                self._to_dev(mates_packed[m0:m1]),
                self._to_dev(np.asarray(lens[m0:m1], dtype=np.int32)),
                self._to_dev(valid_bits[m0:m1]),
                num_reads=r1 - r0, nm=nm, d=d, **geo,
            )
            pending.append((r0, r1, rep))
        return self._fetch(out, pending)

    def readid_counts_arrays(
        self,
        rows: np.ndarray,
        seg: np.ndarray,
        pos: np.ndarray,
        n_reads: int,
        start_sample: int,
    ) -> np.ndarray:
        """Per-read counts from prepared flattened arrays (seg sorted asc),
        in chunks of reads so one dispatch stays within a bounded k-mer
        budget."""
        from .ops.query import query_readid_batch

        out = np.zeros((n_reads, self.index.n_colors + 1), dtype=np.int32)
        rows = rows.astype(np.int64 if self._wide else np.int32, copy=False)
        pending = []
        for r0, r1, lo, hi in self._rid_chunks(n_reads, seg):
            if hi == lo:
                continue
            rep = query_readid_batch(
                self.blocks2,
                self._to_dev(rows[lo:hi]),
                self._to_dev((seg[lo:hi] - r0).astype(np.int32)),
                self._to_dev(np.asarray(pos[lo:hi], dtype=np.int32)),
                num_reads=r1 - r0, start_sample=start_sample,
                num_colors=self.index.n_colors, wpad=self.wpad, rpb=self.rpb,
            )
            pending.append((r0, r1, rep))
        return self._fetch(out, pending)
