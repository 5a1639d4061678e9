"""QueryEngine: device-resident index + chunked query execution.

Hosts the bit-slice matrix on the device once and streams k-mer batches
through the gather/AND/count ops. String work happens on the host; only
dense integer tensors cross to the device. Dense queries take a sorted
stream (ops/stream_query.py and its CUDA kernels): the row stream on a
classic index of <= 32 colors, the probe stream on a blocked v2/v3/v4 index
of <= 1024 colors. Everything else takes the generic gather (ops/query.py).
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


def _dev_vec(stats, n_drop, hist) -> torch.Tensor:
    """What a device-resident dispatch leaves for one fetch
    (search_keys_dev_finish decodes it)."""
    return torch.cat([stats, n_drop.reshape(1), hist.reshape(-1)])


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
        if self.bv and (index.place_rpb or self.rpb) != self.rpb:
            raise NotImplementedError(
                "shard-placed blocked indexes (build --color-shards) are not "
                "yet ported in colorid_tpu_torch (ROADMAP queue 1: sharded "
                "engines)"
            )
        self.blocks2 = _i32(blocks).to(self.device)
        q = max(self.wpad // 128, 1)
        if index.bloom_size * (q if self.wpad > 128 else 1) >= 2**31:
            raise NotImplementedError(
                "bloom_size beyond int32 block addressing "
                "(query_accumulate_scan_wide) is not yet ported in "
                "colorid_tpu_torch (ROADMAP queue 1)"
            )
        # wide rows multiply the epilogue's [chunk, wpad] footprint; cap the
        # scan chunk so it stays memory-friendly
        if self.wpad > 128:
            self.chunk = min(self.chunk, max((1 << 29) // (self.wpad * 128), 2048))
        stream_on = os.environ.get("COLORID_STREAM", "1") != "0"
        self._stream = (
            self.bv in (2, 3, 4)  # split-lane placements
            and index.num_hash in STREAM_HASHES
            and self.wpad in STREAM_WPADS  # <= 1024 colors
            and stream_on
        )
        self._stream_classic = (
            self.bv == 0  # reference-placement (classic) rows
            and self.wpad == 1  # <= 32 colors (wider rows: generic gather)
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
        """Row indices [N, H] int32 for canonical k-mer byte rows [N, k]:
        XXH3 rows, or the blocked placement of a blocked index."""
        if self.bv:
            from .ops.blocked import blocked_rows_host

            return blocked_rows_host(
                keys, self.index.num_hash, self.index.bloom_size, self.rpb,
                version=self.bv,
            ).astype(np.int32)
        if keys.shape[0] and native.available():
            rows = native.xxh3_rows(keys, self.index.num_hash, self.index.bloom_size)
        else:
            rows = bloom_rows_batch(keys, self.index.num_hash, self.index.bloom_size)
        return rows.astype(np.int32)

    # -- search (batch_search_pe / perfect_search hot loop) ------------------

    def _new_accumulators(self, capO: int):
        C = self.index.n_colors
        stats = torch.zeros(C + self.wpad + 2, dtype=torch.int32, device=self.device)
        stats[C : C + self.wpad] = -1  # and-words
        stats[C + self.wpad] = 1  # all-valid flag
        hist = torch.zeros((C, FREQ_CAP), dtype=torch.int32, device=self.device)
        oc_buf = torch.zeros(capO, dtype=torch.int32, device=self.device)
        of_buf = torch.zeros(capO, dtype=torch.int32, device=self.device)
        return stats, hist, oc_buf, of_buf

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
        W = self.index.words_per_row
        if n == 0:
            none = np.zeros(0, dtype=np.int32)
            return SearchResult(
                np.zeros(C, dtype=np.int64), True,
                np.full(W, 0xFFFFFFFF, dtype=np.uint32),
                np.zeros((C, FREQ_CAP), dtype=np.int64), none, none,
            )
        if packed_all is not None and not (k and 4 <= k <= 32):
            # device hash envelope exceeded: fall back to host hashing
            packed_all = None
            if keys is None and rows_all is None:
                raise ValueError(
                    "packed_all is outside the device-hash envelope "
                    f"(k={k}; need 4 <= k <= 32) and no keys/rows were given "
                    "to hash host-side"
                )
        if packed_all is None and rows_all is None:
            k = keys.shape[1]
            if 4 <= k <= 32:
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

                size = _round_up(m, chunk if m > chunk else min(16384, chunk))
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
                    _i32(rows_all[start:stop].astype(np.int32)).to(self.device),
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
        vec, oc_buf, of_buf, capO = self.search_keys_dev_async(
            pk_dev, qc_dev, k=k, max_freq=max_freq
        )
        return self.search_keys_dev_finish(vec.cpu().numpy(), oc_buf, of_buf, capO)

    def _check_dev_batch(self, name: str, pk_dev, qc_dev, k: int, unit: int):
        if not (4 <= k <= 32):
            raise ValueError("device hashing needs 4 <= k <= 32")
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
        self, pk_dev: torch.Tensor, qc_dev: torch.Tensor, k: int
    ):
        """Device-resident exact-mode query through the GENERIC gather:
        works on every layout. Same contract as search_keys_dev_async
        (decode with search_keys_dev_finish). P must be a multiple of the
        engine chunk; qc_dev are full int32 frequencies with 0 = pad."""
        chunk = min(self.chunk, 1 << 20)
        self._check_dev_batch("search_keys_dev_generic", pk_dev, qc_dev, k, chunk)
        capO = 1 << 18
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
        vec, oc_buf, of_buf, capO = self.search_keys_dev_classic_async(
            _i32(pk).to(self.device), _i32(qc).to(self.device), k,
            capO=_round_up(n, 1024),
        )
        return self.search_keys_dev_finish(vec.cpu().numpy(), oc_buf, of_buf, capO)

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
