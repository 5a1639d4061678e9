"""Query engine over a ("data", "color"|"row") logical mesh.

Drop-in for engine.QueryEngine.search_keys: the bit-slice matrix shards
across the model axis (color slices keep every gather shard-local; row
slices scale memory), k-mer batches split across the data axis, and the
per-color counts sum over the shards (parallel/sharded.py). Returns the same
SearchResult contract (exact uniq-hit frequency statistics), with the
per-k-mer uniq colors assembled host-side on the generic path.

Dense queries take a sorted stream: on the row layout the single-device
probe stream per row shard (v3/v4 indexes of <= 1024 colors), on the color
layout the raw probe stream per color shard (an index built with
``build --color-shards N`` on a mesh of N color shards, which is what lets
an index wider than 1024 colors stream at all).

A row layout may also start from a matrix born sharded on the devices
(ops/build_ops.py::build_matrix_rowshard + pack_blocks_rowshard, passed as
``sharded_matrix``): the full matrix then never exists on the host, and
the engine decides its gather and its stream as for the host matrix.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..engine import SearchResult, _i32, _round_up, host_rows
from ..index.bigsi import BigsiIndex
from ..ops.blocked import pack_keys_u64, rows_per_block, v3_block_offsets
from ..ops.query import FREQ_CAP, row_wpad
from ..ops.stream_query import OVER_CAP, PC, STREAM_HASHES, STREAM_WPADS
from ..runtime import resolve_device
from . import sharded


def _placement_rpb(index: BigsiIndex) -> int:
    """The build-time placement group of a blocked index (0: classic rows)."""
    if not index.blocked:
        return 0
    return index.place_rpb or rows_per_block(row_wpad(index.words_per_row))


def _splits(index: BigsiIndex) -> bool:
    """Value-addressed placement the probe stream can take."""
    return index.blocked in (3, 4) and index.num_hash in STREAM_HASHES


def _row_stream_ok(index: BigsiIndex) -> bool:
    """Whether the probe stream runs per row shard: a value-addressed
    placement (blocks monotone in the k-mer value, so sorted probes split
    at the shard boundaries) of the full row width."""
    wpad_g = row_wpad(index.words_per_row)
    return (
        _splits(index) and wpad_g in STREAM_WPADS
        and _placement_rpb(index) == 128 // wpad_g
    )


class ShardedQueryEngine:
    def __init__(
        self,
        index: BigsiIndex,
        mesh: sharded.Mesh | None = None,
        layout: str = "color",
        n_data: int = 1,
        chunk: int = 1 << 18,
        device: str | torch.device = "cuda",
        sharded_matrix: tuple | None = None,
    ):
        """``mesh`` decides the shards and their devices; without one, the
        mesh is n_data x (cards // n_data) shards of ``layout`` on
        ``device`` (default the CUDA card; raises without one).

        ``sharded_matrix`` = (blocks, wpad, Rl): per-row-shard packed blocks
        already on the mesh's devices (ops/build_ops.py::
        pack_blocks_rowshard), for layout "row"; index.matrix may then be
        None. Rl must be a multiple of row_multiple(index)."""
        self.index = index
        self.layout = layout
        self.chunk = chunk
        if index.bloom_size >= 2**31:
            raise ValueError(
                "ShardedQueryEngine hashes global rows in int32; "
                "bloom_size >= 2^31 is served by the single-device "
                "QueryEngine's wide path (int64 rows through the generic "
                "gather, ops/query.py::query_accumulate_scan)"
            )
        if sharded_matrix is not None and layout != "row":
            raise ValueError("sharded_matrix requires layout='row'")
        if mesh is None:
            dev = resolve_device(device)
            n = torch.cuda.device_count() if dev.type == "cuda" else 1
            mesh = sharded.make_mesh(
                n_data, max(n // n_data, 1), layout, devices=[dev]
            )
        if mesh.model_axis != layout:
            raise ValueError(
                f"layout {layout!r} needs a mesh whose model axis is "
                f"{layout!r}; got {mesh.model_axis!r}"
            )
        self.mesh = mesh
        self.rpb = 0  # blocked single-fetch gather (0 = generic gather)
        self._stream = False  # sorted-stream eligibility
        wpad_g = row_wpad(index.words_per_row)
        self.rpb_place = _placement_rpb(index)
        if layout == "color":
            self.mat, self.wpad, self.Wl = sharded.device_put_colorshard(
                np.asarray(index.matrix), mesh
            )
        elif sharded_matrix is not None:
            self.mat, self.wpad, self.Rl = sharded_matrix
            mult = self.row_multiple(index)
            if (
                len(self.mat) != mesh.n_model or self.wpad != wpad_g
                or self.Rl % mult
            ):
                raise ValueError(
                    f"sharded_matrix of {len(self.mat)} shards, wpad "
                    f"{self.wpad}, {self.Rl} rows per shard does not fit a "
                    f"mesh of {mesh.n_model} row shards and this index (wpad "
                    f"{wpad_g}, rows per shard a multiple of {mult}: "
                    "build_matrix_rowshard(..., row_multiple=ShardedQueryEngine."
                    "row_multiple(index)))"
                )
        else:
            self.mat, self.wpad, self.Rl = sharded.device_put_rowshard(
                np.asarray(index.matrix), mesh,
                row_multiple=self.row_multiple(index),
            )
        # blocked layout: a k-mer's H rows share one build-time row group;
        # a power-of-two shard-local rows-per-block >= that group nests it,
        # so each shard serves a k-mer with ONE block fetch. A narrower
        # local block (an index placed for narrower shards than this
        # mesh's) does not: such a mesh gathers row by row.
        if self.rpb_place and self.wpad <= 128 and 128 // self.wpad >= self.rpb_place:
            self.rpb = 128 // self.wpad
        if layout == "color":
            # shard-placed (build --color-shards) value-addressed index
            # whose placement group matches THIS mesh's shard width: the
            # raw probe stream runs per color shard
            self._stream = (
                _splits(index) and self.wpad in STREAM_WPADS
                and self.rpb_place == self.rpb
            )
        else:
            self._stream = _row_stream_ok(index)

    @staticmethod
    def row_multiple(index: BigsiIndex) -> int:
        """What the rows per shard of a row mesh must be a multiple of for
        this index: the stream tiles each shard's matrix in 128-block
        windows, so shard boundaries fall on tile boundaries; a blocked row
        group never straddles two shards."""
        if _row_stream_ok(index):
            return 128 * _placement_rpb(index)
        return 128 if index.blocked else 1

    def _rows(self, keys: np.ndarray) -> np.ndarray:
        # the index's build-time placement, not the shard-local gather
        # grouping self.rpb
        return host_rows(self.index, keys, self.rpb_place)

    def search_keys(
        self, keys: np.ndarray, qcounts: np.ndarray | None = None
    ) -> SearchResult:
        index = self.index
        C = index.n_colors
        W = index.words_per_row
        n = keys.shape[0]
        counts = np.zeros(C, dtype=np.int64)
        and_all = np.full(W, 0xFFFFFFFF, dtype=np.uint32)
        hist = np.zeros((C, FREQ_CAP), dtype=np.int64)
        none = np.zeros(0, dtype=np.int32)
        if n == 0:
            return SearchResult(counts, True, and_all, hist, none, none)
        if qcounts is None:
            qcounts = np.ones(n, dtype=np.int32)
        res = self._try_stream_keys(keys, qcounts)
        if res is not None:
            return res
        rows_all = self._rows(keys)
        uniq_color = np.full(n, -1, dtype=np.int32)
        all_valid = True
        nd = self.mesh.n_data
        for start in range(0, n, self.chunk):
            stop = min(start + self.chunk, n)
            m = stop - start
            size = _round_up(m, max(nd * 8, 1024))
            rows = np.zeros((size, index.num_hash), dtype=np.int32)
            rows[:m] = rows_all[start:stop]
            mask = np.zeros(size, dtype=bool)
            mask[:m] = True
            rows_t, mask_t = torch.from_numpy(rows), torch.from_numpy(mask)
            if self.layout == "color":
                c, u, _v, aa, av = sharded.query_batch_colorshard(
                    self.mat, rows_t, mask_t,
                    mesh=self.mesh, wpad=self.wpad, Wl=self.Wl, rpb=self.rpb,
                )
                counts += c.cpu().numpy().reshape(-1)[:C]
                and_all &= aa.cpu().numpy().view(np.uint32)[:W]
            else:
                c, u, _v, aa, av = sharded.query_batch_rowshard(
                    self.mat, rows_t, mask_t,
                    mesh=self.mesh, wpad=self.wpad, Rl=self.Rl,
                    W=W, rpb=self.rpb,
                )
                counts += c.cpu().numpy()[:C]
                and_all &= aa.cpu().numpy().view(np.uint32)[:W]
            uniq_color[start:stop] = u.cpu().numpy()[:m]
            all_valid = all_valid and bool(av)
        return self._finish(
            counts, all_valid, and_all, hist, uniq_color, qcounts
        )

    def _try_stream_keys(self, keys, qcounts) -> SearchResult | None:
        """The sorted-stream paths: one dispatch of the probe stream per
        shard over the probes sorted by block (sharded.py's module notes).
        Hashing and sorting run on the host. Returns None when ineligible
        or when a shard exceeded its residual/overflow capacity (the caller
        reruns the generic path)."""
        index = self.index
        if not self._stream or os.environ.get("COLORID_STREAM", "1") == "0":
            return None
        key_len = index.m_size or index.k_size
        if keys.shape[1] != key_len or not (4 <= key_len <= 32):
            return None
        C = index.n_colors
        H = index.num_hash
        rpb = self.rpb  # shard grouping == build placement on both layouts
        blk, offs = v3_block_offsets(
            pack_keys_u64(keys), key_len, H, index.bloom_size, rpb,
            version=int(index.blocked),
        )
        offp = offs[:, 0].astype(np.uint32)
        for h in range(1, H):
            offp |= offs[:, h].astype(np.uint32) << np.uint32(8 * h)
        qc = np.minimum(
            np.maximum(np.asarray(qcounts), 1), 2**31 - 1
        ).astype(np.int32)
        order = np.argsort(blk, kind="stable")
        blk_s = blk[order].astype(np.int32)
        offp_s = offp[order]
        qc_s = qc[order]
        if self.layout == "color":
            return self._stream_colorshard_finish(blk_s, offp_s, qc_s, H, rpb)
        nd = self.mesh.n_data
        nr = self.mesh.n_model
        nbl = self.Rl // rpb  # blocks owned per row shard
        bounds = np.searchsorted(
            blk_s, np.arange(nr + 1, dtype=np.int64) * nbl
        )
        Pl_max = int((bounds[1:] - bounds[:-1]).max())
        P2 = max(_round_up(-(-max(Pl_max, 1) // nd), PC), PC)
        # padding probes carry the shard's base block (in-window) + qc == 0
        b3 = np.broadcast_to(
            (np.arange(nr, dtype=np.int32) * nbl)[None, :, None], (nd, nr, P2)
        ).copy()
        o3 = np.zeros((nd, nr, P2), dtype=np.uint32)
        q3 = np.zeros((nd, nr, P2), dtype=np.int32)
        for r in range(nr):
            lo, hi = int(bounds[r]), int(bounds[r + 1])
            per = -(-(hi - lo) // nd) if hi > lo else 0
            for d in range(nd):
                a = lo + d * per
                b = min(lo + (d + 1) * per, hi)
                if b <= a:
                    continue
                m = b - a
                b3[d, r, :m] = blk_s[a:b]
                o3[d, r, :m] = offp_s[a:b]
                q3[d, r, :m] = qc_s[a:b]
        counts, aw, ok, hist, ndrop, n_over, oc, of = (
            sharded.stream_batch_rowshard(
                self.mat, _i32(b3), _i32(o3), _i32(q3), mesh=self.mesh,
                wpad=self.wpad, num_hash=H, rpb=rpb, n_colors=C, nbl=nbl,
            )
        )
        if int(ndrop) > 0:
            return None
        W = index.words_per_row
        over_c, over_f = self._overflow_lists(n_over, oc, of, 0)
        return SearchResult(
            counts.cpu().numpy()[:C].astype(np.int64),
            bool(ok > 0),
            aw.cpu().numpy().view(np.uint32)[:W].copy(),
            hist.cpu().numpy().astype(np.int64),
            over_c,
            over_f,
        )

    @staticmethod
    def _overflow_lists(n_over, oc, of, shard_base: int):
        """Concatenate the per-shard overflow lists ([nd, S] lengths,
        [nd, S, cap] entries); shard s's colors are re-based by
        s * shard_base."""
        no = n_over.cpu().numpy()
        over_c: list[np.ndarray] = []
        over_f: list[np.ndarray] = []
        for d in range(no.shape[0]):
            for s in range(no.shape[1]):
                m = int(no[d, s])
                if m:
                    over_c.append(oc[d, s, :m].cpu().numpy() + s * shard_base)
                    over_f.append(of[d, s, :m].cpu().numpy())
        none = np.zeros(0, dtype=np.int32)
        return (
            np.concatenate(over_c).astype(np.int32) if over_c else none,
            np.concatenate(over_f).astype(np.int32) if over_f else none,
        )

    def _stream_colorshard_finish(self, blk_s, offp_s, qc_s, H, rpb):
        """Color-sharded stream dispatch + host assembly: per-shard counts /
        and-words / histograms concatenate at each shard's color base; the
        overflow lists carry shard-local colors the host re-bases."""
        index = self.index
        C = index.n_colors
        W = index.words_per_row
        nd = self.mesh.n_data
        S = self.mesh.n_model
        n = blk_s.shape[0]
        n_blocks = index.bloom_size // rpb
        P2 = _round_up(max(n, 1), nd * PC)
        blk_p = np.full(P2, n_blocks - 1, dtype=np.int32)
        blk_p[:n] = blk_s
        off_p = np.zeros(P2, dtype=np.uint32)
        off_p[:n] = offp_s
        qc_p = np.zeros(P2, dtype=np.int32)
        qc_p[:n] = qc_s
        Cl = 32 * self.wpad  # shard color-bit capacity (kernel layout)
        cp = -(-(Cl + 1) // 128) * 128
        counts32, and_b, ok, hist, ndrop, n_over, oc, of = (
            sharded.stream_batch_colorshard(
                self.mat, _i32(blk_p), _i32(off_p), _i32(qc_p),
                mesh=self.mesh, wpad=self.wpad, num_hash=H, rpb=rpb,
                Cl=Cl, cp=cp, cap=OVER_CAP,
            )
        )
        if int(ndrop) > 0:
            return None
        Wl32 = 32 * self.Wl  # live colors per shard
        counts = counts32[:, :Wl32].cpu().numpy().reshape(-1)[:C]
        aw = and_b[:, : self.Wl].contiguous().cpu().numpy().view(np.uint32).reshape(-1)[:W]
        hist_np = hist[:, :Wl32].cpu().numpy().reshape(-1, FREQ_CAP)[:C]
        over_c, over_f = self._overflow_lists(n_over, oc, of, Wl32)
        return SearchResult(
            counts.astype(np.int64),
            bool(ok > 0),
            aw.copy(),
            hist_np.astype(np.int64),
            over_c,
            over_f,
        )

    def _finish(self, counts, all_valid, and_all, hist, uniq_color, qcounts):
        """Exact uniq-hit frequency stats, host-side."""
        sel = uniq_color >= 0
        uc = uniq_color[sel]
        uq = np.asarray(qcounts, dtype=np.int64)[sel]
        small = uq < FREQ_CAP
        np.add.at(hist, (uc[small], uq[small]), 1)
        return SearchResult(
            counts,
            all_valid,
            and_all,
            hist,
            uc[~small].astype(np.int32),
            uq[~small].astype(np.int32),
        )
