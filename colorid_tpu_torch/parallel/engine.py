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

The engine is also a drop-in for the single-device engine in the read
classifier (pipelines/read_id.py::classify_batch and read_id call its
readid_counts, readid_counts_arrays, readid_counts_packed and
readid_firsthit: reads split over the data axis, the matrix over the model
axis), and it counts k-mers of reads on the devices (search_reads: each
data slice extracts its reads' windows, one global merge makes the counts
exact, then the generic sharded query).

Across processes (parallel/distributed.py::initialize first, one process
per card), the engine runs on a ("data" = 1, "row" = n) mesh whose shards
live in several processes: every rank builds the engine and calls each
method with the same arguments, gathers from the shards it holds, and
gets the whole answer after one collective per merged quantity. That is
what the JAX package completes across processes: its color layout, its
n_data > 1 meshes and its row stream fail there at a fetch of an array
that spans other processes' devices, so the port's mesh refuses the first
two (sharded.Mesh) and gathers generically where the row stream would
run (the JAX package's COLORID_STREAM=0 route, the same SearchResult).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..engine import SearchResult, _i32, _round_up, flatten_keys, host_rows
from ..index.bigsi import BigsiIndex
from ..ops.blocked import pack_keys_u64, rows_per_block, v3_block_offsets
from ..ops.query import BIG, FREQ_CAP, PAD_POS, row_wpad
from ..ops.stream_query import OVER_CAP, PC, STREAM_HASHES, STREAM_WPADS
from ..runtime import resolve_device
from . import distributed, sharded


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
        ``device`` (default the CUDA card; raises without one), or, inside
        a group of more than one process, n_data x (processes // n_data)
        shards with this process's on ``device``.

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
            if distributed.is_multi_process():
                n = torch.distributed.get_world_size()
            else:
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
            blocks, self.wpad, self.Rl = sharded_matrix
            self.mat = sharded.replicate(blocks, mesh)
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
            # the JAX row stream fails across processes (it fetches the
            # per-shard overflow counts, P("data", "row"),
            # colorid_tpu/parallel/engine.py:270)
            self._stream = _row_stream_ok(index) and not mesh.spans_processes

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
            c, aa, u, av = self._query_batch(
                self._home(rows), torch.from_numpy(mask).to(self.mesh.home))
            counts += c
            and_all &= aa
            uniq_color[start:stop] = u[:m]
            all_valid = all_valid and av
        return self._finish(
            counts, all_valid, and_all, hist, uniq_color, qcounts
        )

    def _query_batch(self, rows: torch.Tensor, mask: torch.Tensor):
        """The generic sharded query of one batch (rows int32 [N, H], mask
        bool [N]) on this engine's layout. Returns host arrays: (counts
        int64 [C], and-words uint32 [W], uniq colors int32 [N], all_valid)."""
        C = self.index.n_colors
        W = self.index.words_per_row
        shard, geo = self._layout_geometry()
        c, u, _v, aa, av = getattr(sharded, f"query_batch_{shard}")(
            self.mat, rows, mask, mesh=self.mesh, wpad=self.wpad, rpb=self.rpb, **geo,
        )
        return (
            c.cpu().numpy()[:C].astype(np.int64),
            aa.cpu().numpy().view(np.uint32)[:W],
            u.cpu().numpy(),
            bool(av),
        )

    def _layout_geometry(self) -> tuple[str, dict]:
        """The suffix of this layout's functions in sharded.py and the shard
        geometry they take."""
        if self.layout == "color":
            return "colorshard", dict(Wl=self.Wl)
        return "rowshard", dict(Rl=self.Rl, W=self.index.words_per_row)

    def _home(self, a) -> torch.Tensor:
        """A host array (uint32 words as their int32 bit view) or a tensor
        on the mesh's home device, where the sharded functions take their
        inputs."""
        if isinstance(a, torch.Tensor):
            return a.to(self.mesh.home)
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(self.mesh.home)

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

    # -- the read classifier on the mesh ---------------------------------------

    def readid_counts(
        self, keys_per_read: list[np.ndarray], start_sample: int
    ) -> np.ndarray:
        """Per-read per-color hit counts [B, C+1] (column C = no_hits): the
        contract and semantics of QueryEngine.readid_counts (break on an
        absent k-mer, the -B two-phase count, keys in set-iteration order),
        with the reads split over the data axis (the reference's rayon
        fan-out, read_id_mt_pe.rs:300-361) and the matrix over the model
        axis."""
        C = self.index.n_colors
        n_reads = len(keys_per_read)
        flat = flatten_keys(keys_per_read, self._rows)
        if flat is None:
            return np.zeros((n_reads, C + 1), dtype=np.int32)
        return self.readid_counts_arrays(*flat, n_reads, start_sample)

    def _partition_reads(self, per_kmer: np.ndarray, seg, pos, n_reads: int):
        """Split flattened per-k-mer arrays (seg ascending) into contiguous
        groups of reads, one per data slice, padded to a common length Nl
        (a multiple of 8). Returns (per_kmer [nd, Nl, ...], seg int32
        [nd, Nl] relative to the slice's first read, pos int32 [nd, Nl]
        (PAD_POS on padding), reads per slice)."""
        nd = self.mesh.n_data
        n_reads_l = -(-n_reads // nd)
        seg = np.asarray(seg, dtype=np.int32)  # the packed route hands int16
        pos = np.asarray(pos, dtype=np.int32)
        bounds = np.searchsorted(
            seg, np.arange(nd + 1, dtype=np.int64) * n_reads_l, "left"
        )
        Nl = _round_up(max(int((bounds[1:] - bounds[:-1]).max()), 1), 8)
        pk = np.zeros((nd, Nl) + per_kmer.shape[1:], dtype=per_kmer.dtype)
        sg = np.zeros((nd, Nl), dtype=np.int32)
        ps = np.full((nd, Nl), PAD_POS, dtype=np.int32)
        for s in range(nd):
            lo, hi = bounds[s], bounds[s + 1]
            n = hi - lo
            if n == 0:
                continue
            pk[s, :n] = per_kmer[lo:hi]
            sg[s, :n] = seg[lo:hi] - np.int32(s * n_reads_l)
            ps[s, :n] = pos[lo:hi]
        return pk, sg, ps, n_reads_l

    def _readid(self, name: str, per_kmer: np.ndarray, seg, pos, n_reads: int,
                start_sample: int, **kw) -> np.ndarray:
        """One sharded read classifier function (sharded.<name>_<layout>
        [_packed]: name holds "{}" where the layout goes) over flattened
        per-k-mer arrays; returns [n_reads, C+1]: the per-read color columns
        and, last, the no-hits flag or the first-absent position."""
        C = self.index.n_colors
        per3, seg2, pos2, n_reads_l = self._partition_reads(per_kmer, seg, pos, n_reads)
        shard, geo = self._layout_geometry()
        cols, last = getattr(sharded, name.format(shard))(
            self.mat, self._home(per3), self._home(seg2), self._home(pos2),
            mesh=self.mesh, wpad=self.wpad, start_sample=start_sample,
            n_reads_l=n_reads_l, rpb=self.rpb, **geo, **kw,
        )
        out = np.empty((n_reads, C + 1), dtype=np.int32)
        out[:, :C] = cols[:n_reads, :C].cpu().numpy()
        out[:, C] = last[:n_reads].cpu().numpy()
        return out

    def readid_counts_arrays(
        self, rows: np.ndarray, seg, pos, n_reads: int, start_sample: int
    ) -> np.ndarray:
        """QueryEngine.readid_counts_arrays on the mesh: prepared flattened
        row arrays (seg ascending), the reads over the data axis."""
        return self._readid("readid_batch_{}", rows.astype(np.int32, copy=False),
                            seg, pos, n_reads, start_sample)

    def _placement(self) -> tuple[int, int]:
        """(rpb_place, bv): the index's build-time hash placement (its row
        group and layout version; (0, 1) for classic XXH3 rows), which the
        device hashing must reproduce. Not self.rpb, the shard-local gather
        grouping."""
        if self.index.blocked:
            return self.rpb_place, int(self.index.blocked)
        return 0, 1

    def readid_counts_packed(
        self, packed: np.ndarray, seg, pos, n_reads: int, start_sample: int,
        k: int,
    ) -> np.ndarray:
        """QueryEngine.readid_counts_packed on the mesh: 2-bit packed
        k-mers uint32 [N, 2] hashed on the devices (12 B per k-mer of host
        traffic), seg / pos (int16 from the read classifier) ascending by
        read."""
        index = self.index
        rpb_place, bv = self._placement()
        return self._readid(
            "readid_batch_{}_packed", np.ascontiguousarray(packed, dtype=np.uint32),
            seg, pos, n_reads, start_sample, k=k, num_hash=index.num_hash,
            bloom_size=index.bloom_size, rpb_place=rpb_place, bv=bv,
        )

    def readid_firsthit(
        self, keys_per_read: list[np.ndarray], start_sample: int
    ) -> np.ndarray:
        """QueryEngine.readid_firsthit on the mesh: the first-hit position
        matrix [B, C+1] (column C = first-absent position; 2**30 = never)
        for the read_id tie-order fixup."""
        n_reads = len(keys_per_read)
        flat = flatten_keys(keys_per_read, self._rows)
        if flat is None:
            return np.full((n_reads, self.index.n_colors + 1), BIG, dtype=np.int32)
        rows, seg, pos = flat
        return self._readid("readid_firsthit_{}", rows.astype(np.int32, copy=False),
                            seg, pos, n_reads, start_sample)

    # -- device k-mer extraction on the mesh -----------------------------------

    def search_reads(
        self,
        reads_packed,
        lens,
        *,
        k: int,
        L: int,
        filter_t: int = 0,
        d: int = 1,
    ) -> tuple[SearchResult, int]:
        """QueryEngine.search_reads on the mesh: reads_packed (2-bit words,
        uint32 [R, ceil(L/16)] on the host or their int32 view as a tensor)
        split over the data axis, k-mer extraction on the devices with one
        global unique merge (sharded.extract_merge_datashard: exact
        whole-batch frequencies and the strictly-greater filter), device
        hashing with the index's build-time placement, then the generic
        sharded query. Reads must be uppercase ACGT (no validity plane).
        Returns (SearchResult, n_unique filtered k-mers)."""
        index = self.index
        if not (4 <= k <= 32 and index.bloom_size < 2**31):
            raise ValueError("search_reads requires the device-hash envelope")
        nd = self.mesh.n_data
        home = self.mesh.home
        R = reads_packed.shape[0]
        NW = L - k + 1
        Rp = _round_up(max(R, nd), nd)
        if Rp * NW >= 2**31:
            raise ValueError(
                "read batch exceeds int32 device indexing; split the batch"
            )
        reads = self._home(reads_packed)
        lens_t = self._home(np.asarray(lens, dtype=np.int32)
                            if not isinstance(lens, torch.Tensor) else lens.to(torch.int32))
        if Rp > R:
            reads = torch.cat([reads, reads.new_zeros((Rp - R, reads.shape[1]))])
            lens_t = torch.cat([lens_t, lens_t.new_zeros(Rp - R)])
        keys2, qc, n_own = sharded.extract_merge_datashard(
            reads, lens_t, mesh=self.mesh, k=k, L=L, filter_t=filter_t, d=d,
        )
        n_own = n_own.cpu().numpy()
        n_u = int(n_own.sum())
        C = index.n_colors
        W = index.words_per_row
        hist = np.zeros((C, FREQ_CAP), dtype=np.int64)
        if n_u == 0:
            none = np.zeros(0, dtype=np.int32)
            return SearchResult(
                np.zeros(C, dtype=np.int64), True,
                np.full(W, 0xFFFFFFFF, dtype=np.uint32), hist, none, none,
            ), 0
        # the tight per-slice prefix over the compacted owned uniques
        T = keys2.shape[0] // nd
        S = min(_round_up(max(int(n_own.max()), 1), 8), T)
        ks = keys2.view(nd, T, 2)[:, :S].reshape(nd * S, 2)
        qs = qc.view(nd, T)[:, :S].reshape(nd * S)
        rpb_place, bv = self._placement()
        rows = sharded.hash_packed_datashard(
            ks, mesh=self.mesh, k=k, num_hash=index.num_hash,
            bloom_size=index.bloom_size, rpb_place=rpb_place, bv=bv,
        )
        counts, and_all, uniq_color, all_valid = self._query_batch(rows, (qs > 0).to(home))
        return (
            self._finish(counts, all_valid, and_all, hist, uniq_color,
                         qs.cpu().numpy()),
            n_u,
        )
