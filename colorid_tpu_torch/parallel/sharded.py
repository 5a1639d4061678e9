"""Sharded query execution on a single-process logical mesh.

The BIGSI engine has three parallel axes:

- **data**: k-mer batches split into slices; per-color counts sum over the
  slices.
- **color**: the bit-slice matrix split along the packed color-word axis.
  Each shard gathers from its own full-height matrix slice; only the
  per-probe hit counts, presence bits and the [C]-sized count vectors are
  combined. The layout for wide (metagenomic) indexes.
- **row**: the matrix split along the Bloom-row axis (each shard owns
  bloom_size/n rows). A shard treats rows it does not own as neutral
  (all-ones words, present) and the partial ANDs combine with a bitwise
  AND. The layout for a matrix that one device cannot hold.

A mesh here is ``n_data x n_model`` shards over a list of devices: shard
(d, m) sits on ``devices[(d * n_model + m) % len(devices)]``, the order in
which the JAX package's make_mesh lays out jax.devices()[:nd * nm], and
every device of a model shard's column holds a copy of its matrix slice
(replicate; JAX's NamedSharding(P(model, None, None))). With one card every
shard lives on it; with ``devices=["cpu"]`` the same code runs on the CPU.
The JAX package's shard_map collectives (psum, pmax, pmin, the AND
all_gather) become plain sums, maxima, minima and ANDs over the per-shard
tensors of an axis, taken on the mesh's home device; what crosses devices
is per-probe vectors and [C]-sized accumulators, never matrix rows.

Inside a torch.distributed group of more than one process
(parallel/distributed.py), make_mesh spans every process's devices, as
jax.devices() does after jax.distributed.initialize. Each process holds
only the shards on its own devices (the others are None) and gathers from
them; the row layout's two merges, the AND of the partial words and the
sum of presences, then run as one collective each, and every process
computes the whole result. Such a mesh has the row layout and one data
row: the JAX package serves nothing else across processes (Mesh's
refusals).

Besides the k-mer query (query_batch_* and the sorted streams), the mesh
runs the read classifier (readid_batch_*, readid_firsthit_*: reads split
over the data axis, the matrix over the model axis) and device k-mer
extraction (extract_merge_datashard: each data slice counts its reads'
windows, one global merge makes the counts exact, hash_packed_datashard
turns the owned k-mers into rows).

Per-shard matrices are packed into the 128-lane block layout of
ops/query.py::pack_matrix_blocks. Words are uint32 bit patterns in int32
tensors throughout.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..engine import _i32
from ..ops.extract import SENT_KEY, _key_limbs, _sort_key, extract_count, value_sort
from ..ops.hash_torch import M32, device_rows
from ..ops.query import (
    BIG,
    FREQ_CAP,
    _and_over_hashes,
    _and_words,
    _bit_counts,
    _first_absent,
    _firsthit_report,
    _gather_rows,
    _gather_rows_blocked,
    _hits,
    _readid_report,
    _to_i32,
    _unpack_bits,
    new_accumulators,
    pack_matrix_blocks,
    row_wpad,
)
from ..runtime import resolve_device
from . import distributed


@dataclass(frozen=True)
class Mesh:
    """n_data x n_model shards; ``model_axis`` names the second axis
    ("color" or "row"). Shard (d, m) sits on global device d * n_model + m
    of ``devices`` (modulo its length). In a mesh across processes,
    ``ranks`` holds each device's owner and this process is ``rank``; in
    one process ``ranks`` is empty."""

    n_data: int
    n_model: int
    model_axis: str
    devices: tuple
    ranks: tuple = ()
    rank: int = 0

    def __post_init__(self):
        if not self.spans_processes:
            return
        if self.model_axis != "row":
            raise ValueError(
                "a mesh across processes has the row layout: on a color mesh the "
                "JAX package's ShardedQueryEngine fetches the counts, sharded "
                "P('color') over other processes' devices, and fails ('Fetching "
                "value for jax.Array that spans non-addressable devices', "
                "colorid_tpu/parallel/engine.py:170)"
            )
        if self.n_data != 1:
            raise ValueError(
                "a mesh across processes has one data row: with n_data > 1 the JAX "
                "package's ShardedQueryEngine fetches per-k-mer outputs sharded "
                "P('data') over other processes' devices and fails ('Fetching value "
                "for jax.Array that spans non-addressable devices', "
                "colorid_tpu/parallel/engine.py:185, :552, :592)"
            )

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.n_data, self.model_axis: self.n_model}

    @property
    def spans_processes(self) -> bool:
        return len(set(self.ranks)) > 1

    @property
    def home(self) -> torch.device:
        """Where this process takes the cross-shard merges: its first
        device."""
        return self.devices[self.ranks.index(self.rank) if self.ranks else 0]

    def _slot(self, m: int, d: int) -> int:
        return (d * self.n_model + m) % len(self.devices)

    def device(self, m: int, d: int = 0) -> torch.device:
        """The device of shard (d, m)."""
        return self.devices[self._slot(m, d)]

    def owns(self, m: int, d: int = 0) -> bool:
        """Whether this process holds shard (d, m)."""
        return not self.ranks or self.ranks[self._slot(m, d)] == self.rank


def make_mesh(n_data: int, n_model: int, model_axis: str, devices=None) -> Mesh:
    """A mesh over ``devices`` (default: the CUDA card; raises without one,
    as every entry point of the package does). Inside an initialized group
    of more than one process, ``devices`` are this process's own and the
    mesh spans every process's (distributed.global_devices: a collective,
    so every rank makes the mesh, with the same shape)."""
    if model_axis not in ("color", "row"):
        raise ValueError(f"model_axis must be 'color' or 'row'; got {model_axis!r}")
    if n_data < 1 or n_model < 1:
        raise ValueError("a mesh needs at least one shard on each axis")
    if devices is None:
        devices = ["cuda"]
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if not distributed.is_multi_process():
        return Mesh(n_data, n_model, model_axis, devs)
    # another process's "cuda" is not this one's: name the card
    devs = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    entries = distributed.global_devices(devs)
    return Mesh(n_data, n_model, model_axis,
                tuple(torch.device(name) for _r, name in entries),
                tuple(r for r, _name in entries), dist.get_rank())


class Shards(list):
    """Per-model-shard packed blocks: item m is model shard m on the device
    of its shard (0, m) (None where another process holds it), and
    ``replicas[(d, m)]`` its copy on the device of shard (d, m) where that
    is another device."""

    def __init__(self, shards, replicas=None):
        super().__init__(shards)
        self.replicas = replicas or {}


def replicate(shards, mesh: Mesh) -> Shards:
    """One tensor per model shard, each on its shard (0, m)'s device, with
    a copy on every other device of the shard's column."""
    replicas = {}
    for m, t in enumerate(shards):
        if t is None:
            continue
        on = {mesh.device(m): t}
        for d in range(1, mesh.n_data):
            dev = mesh.device(m, d)
            if dev not in on:
                on[dev] = t.to(dev)
            if on[dev] is not t:
                replicas[(d, m)] = on[dev]
    return Shards(shards, replicas)


def _shard(mat, m: int, d: int):
    """Model shard m's blocks on the device of shard (d, m)."""
    return getattr(mat, "replicas", {}).get((d, m), mat[m])


def _gather(mat, rows, wpad, rpb):
    """Local-shard gather: single-block fetch for blocked layouts (a k-mer's
    H rows share one rpb-row block; nesting holds for any shard-local rpb
    that is a power-of-two multiple of the build-time rows-per-block), else
    the generic per-row gather."""
    if rpb:
        return _gather_rows_blocked(mat, rows, wpad, rpb)
    return _gather_rows(mat, rows, wpad)


def _color_and_present(mat, rows, mesh: Mesh, wpad: int, Wl: int, rpb: int, d: int = 0):
    """Rows int32 [N, H] of data slice d gathered on every shard of a
    ("data", "color") mesh: per shard s the AND over the hashes of its
    color slice (int32 [N, Wl], on shard (d, s)'s device), and the rows'
    presence (bool [N], on the home device): a row is absent only where it
    is zero in every shard's slice."""
    home = mesh.home
    andw, seen = [], None  # seen [N, H]: hash row nonzero in some shard
    for s in range(mesh.n_model):
        g = _gather(_shard(mat, s, d), rows.to(mesh.device(s, d)), wpad, rpb)[:, :, :Wl]
        andw.append(_and_over_hashes(g))
        nz = (g != 0).any(dim=2).to(home)
        seen = nz if seen is None else seen | nz
    return andw, seen.all(dim=1)


def _row_and_present(mat, rows, mesh: Mesh, wpad: int, Rl: int, W: int, rpb: int,
                     d: int = 0):
    """Rows int32 [N, H] of data slice d gathered on a ("data", "row") mesh
    whose shard r holds rows [r * Rl, (r + 1) * Rl): the AND over the
    hashes (int32 [N, W]) and the rows' presence (bool [N]), both on the
    home device. A shard treats the rows it does not own as neutral
    (all-ones words) and counts the rows it owns that are nonzero; a k-mer
    is present when all H of its rows count (each row has one owner). This
    process merges the shards it holds; on a mesh across processes the
    merged words then AND, and the counts sum, over the ranks (the JAX
    body's AND all_gather and psum over "row"), so every rank returns the
    whole answer."""
    home = mesh.home
    N, H = rows.shape
    andw = torch.full((N, W), -1, dtype=torch.int32, device=home)
    n_present = torch.zeros(N, dtype=torch.int32, device=home)
    for r in range(mesh.n_model):
        if not mesh.owns(r, d):
            continue
        local = rows.to(mesh.device(r, d)) - r * Rl
        owned = (local >= 0) & (local < Rl)
        g = _gather(_shard(mat, r, d), local.clamp(0, Rl - 1), wpad, rpb)[:, :, :W]
        g = torch.where(owned[:, :, None], g, -1)  # neutral for the AND
        andw &= _and_over_hashes(g).to(home)
        n_present += ((g != 0).any(dim=2) & owned).sum(dim=1, dtype=torch.int32).to(home)
    if mesh.spans_processes:
        andw = distributed.all_and(andw)
        n_present = distributed.all_sum(n_present)
    return andw, n_present == H


def device_put_colorshard(matrix: np.ndarray, mesh: Mesh):
    """Split the color-word axis across the mesh's color shards and pack
    each for the block gather. Returns (blocks, wpad, Wl): the n_shards
    int32 [nb, 128] tensors (Shards: each on its shards' devices), the
    shards' packed row width and their live words per row."""
    n = mesh.shape["color"]
    R, W = matrix.shape
    Wl = -(-W // n)
    wpad = row_wpad(Wl)
    shards = []
    for i in range(n):
        sl = np.zeros((R, Wl), dtype=np.uint32)
        lo = i * Wl
        hi = min(W, (i + 1) * Wl)
        if hi > lo:
            sl[:, : hi - lo] = matrix[:, lo:hi]
        b, wp = pack_matrix_blocks(sl)
        assert wp == wpad
        shards.append(_i32(b).to(mesh.device(i)))
    return replicate(shards, mesh), wpad, Wl


def device_put_rowshard(matrix: np.ndarray, mesh: Mesh, row_multiple: int = 1):
    """Split the Bloom-row axis across the mesh's row shards and pack each.
    Returns (blocks, wpad, rows_per_shard). row_multiple rounds the shard
    height (a blocked layout's row group must never straddle a shard
    boundary, and the stream's tile windows need whole tiles). On a mesh
    across processes every rank passes the same host matrix, as every JAX
    process does, and packs only the shards it holds (the others are
    None)."""
    n = mesh.shape["row"]
    R, W = matrix.shape
    Rl = -(-R // n)
    Rl = -(-Rl // row_multiple) * row_multiple
    wpad = row_wpad(W)
    shards = []
    for i in range(n):
        if not mesh.owns(i):
            shards.append(None)
            continue
        sl = np.zeros((Rl, W), dtype=np.uint32)
        lo = i * Rl
        hi = min(R, (i + 1) * Rl)
        if hi > lo:
            sl[: hi - lo] = matrix[lo:hi]
        b, wp = pack_matrix_blocks(sl)
        assert wp == wpad
        shards.append(_i32(b).to(mesh.device(i)))
    return replicate(shards, mesh), wpad, Rl


def _data_slices(n: int, nd: int):
    if n % nd:
        raise ValueError(f"batch of {n} does not split over {nd} data shards")
    per = n // nd
    return [slice(d * per, (d + 1) * per) for d in range(nd)]


# ---------------------------------------------------------------------------
# color-sharded query
# ---------------------------------------------------------------------------


def query_batch_colorshard(mat, rows, mask, *, mesh, wpad, Wl, rpb=0):
    """The generic gather -> AND -> count query on a ("data", "color")
    mesh. rows int32 [N, H], mask bool [N], N a multiple of n_data. Returns
    (counts int32 [S * 32 * Wl], uniq int32 [N] (color or -1), valid bool
    [N], and_all int32 [S * Wl], all_valid bool scalar), counts and and_all
    concatenated over the color shards. rpb > 0 takes the blocked
    single-fetch gather on each shard."""
    S = mesh.shape["color"]
    home = mesh.home
    Cl = 32 * Wl
    counts = [torch.zeros(Cl, dtype=torch.int64, device=mesh.device(s)) for s in range(S)]
    n_valid = torch.zeros((), dtype=torch.int64, device=home)
    ok = torch.ones((), dtype=torch.bool, device=home)
    uniq, valid_all = [], []
    for d, sl in enumerate(_data_slices(rows.shape[0], mesh.n_data)):
        mask_d = mask[sl].to(home)
        andw, present = _color_and_present(mat, rows[sl], mesh, wpad, Wl, rpb, d)
        andw = [a.to(torch.int64) & M32 for a in andw]
        valid = present & mask_d
        nhits = torch.zeros(valid.shape[0], dtype=torch.int64, device=home)
        color = torch.full_like(nhits, -1)
        for s in range(S):
            v = valid.to(andw[s].device)
            aw_v = torch.where(v[:, None], andw[s], 0)
            counts[s] += _bit_counts(aw_v).to(counts[s].device)
            nh_l, c_l = _hits(aw_v)
            nhits += nh_l.to(home)
            color = torch.maximum(
                color, torch.where(nh_l > 0, c_l + s * Cl, -1).to(home)
            )
        uniq.append(torch.where(valid & (nhits == 1), color, -1).to(torch.int32))
        valid_all.append(valid)
        n_valid += valid.sum()
        ok &= (present | ~mask_d).all()
    and_all = torch.cat([
        _to_i32(_and_words(counts[s], n_valid.to(counts[s].device), Wl)).to(home)
        for s in range(S)
    ])
    counts = torch.cat([c.to(home) for c in counts]).to(torch.int32)
    return counts, torch.cat(uniq), torch.cat(valid_all), and_all, ok


# ---------------------------------------------------------------------------
# row-sharded query
# ---------------------------------------------------------------------------


def query_batch_rowshard(mat, rows, mask, *, mesh, wpad, Rl, W, rpb=0):
    """The same query on a ("data", "row") mesh: shard r holds rows
    [r * Rl, (r + 1) * Rl). Returns (counts int32 [32 * W], uniq, valid,
    and_all int32 [W], all_valid). rpb > 0 takes the blocked single-fetch
    gather (Rl must be a multiple of the blocked row group)."""
    home = mesh.home
    counts = torch.zeros(32 * W, dtype=torch.int64, device=home)
    n_valid = torch.zeros((), dtype=torch.int64, device=home)
    ok = torch.ones((), dtype=torch.bool, device=home)
    uniq, valid_all = [], []
    for d, sl in enumerate(_data_slices(rows.shape[0], mesh.n_data)):
        mask_d = mask[sl].to(home)
        andw, present = _row_and_present(mat, rows[sl], mesh, wpad, Rl, W, rpb, d)
        valid = present & mask_d
        aw_v = torch.where(valid[:, None], andw.to(torch.int64) & M32, 0)
        counts += _bit_counts(aw_v)
        nhits, color = _hits(aw_v)
        uniq.append(torch.where(valid & (nhits == 1), color, -1).to(torch.int32))
        valid_all.append(valid)
        n_valid += valid.sum()
        ok &= (present | ~mask_d).all()
    and_all = _to_i32(_and_words(counts, n_valid, W))
    return counts.to(torch.int32), torch.cat(uniq), torch.cat(valid_all), and_all, ok


# ---------------------------------------------------------------------------
# row-sharded sorted-stream query (value-addressed v3/v4 blocked layouts)
# ---------------------------------------------------------------------------
#
# The single-device probe stream (ops/stream_query.py::_stream_core) runs
# unchanged per shard of a ("data", "row") mesh, because the blocked layout
# keeps ALL of a k-mer's rows in one 512-byte block: each probe is owned by
# exactly ONE row shard, so a sorted probe stream partitions into contiguous
# per-shard slices at the shard block boundaries (the value-addressed
# placement is monotone) and every per-probe statistic is local. Only the
# final merge crosses shards: sums of counts and histograms, an AND of the
# and-words, a minimum of the all-valid flags.


def stream_batch_rowshard(
    mat, blk, offp, qc, *, mesh, wpad, num_hash, rpb, n_colors, nbl
):
    """Sorted-stream query over a ("data", "row") mesh.

    blk/offp/qc are int32 [nd, nr, Pl]: probe slices partitioned by shard
    block ownership (blk ascending within each slice, GLOBAL block ids, nbl
    blocks per shard; qc == 0 marks padding; Pl a multiple of the stream
    chunk). Returns (counts int32 [C], and-words int32 [wpad], ok, hist
    int32 [C, FREQ_CAP], n_dropped, and the per-shard overflow lists n_over
    [nd, nr], oc/of [nd, nr, capO] in exact mode: of holds frequencies)."""
    from ..ops.stream_query import OVER_CAP, RES_CAP, _stream_core

    C = n_colors
    nd, nr = mesh.n_data, mesh.shape["row"]
    home = mesh.home
    capO = OVER_CAP + RES_CAP
    outs = []
    for d in range(nd):
        for r in range(nr):
            dev = mesh.device(r, d)
            b = (blk[d, r].to(dev) - r * nbl).contiguous()
            q = qc[d, r].to(dev).contiguous()
            outs.append(_stream_core(
                *new_accumulators(C, wpad, capO, dev), _shard(mat, r, d), b,
                offp[d, r].to(dev).contiguous(), q, q,  # exact mode
                wpad=wpad, num_hash=num_hash, rpb=rpb, n_colors=C,
            ))
    stats = torch.stack([o[0].to(home) for o in outs])  # [nd * nr, C + W + 2]
    counts = stats[:, :C].sum(dim=0, dtype=torch.int32)
    aw = stats[0, C : C + wpad].clone()
    for i in range(1, stats.shape[0]):
        aw &= stats[i, C : C + wpad]
    ok = stats[:, C + wpad].min()
    hist = torch.stack([o[1].to(home) for o in outs]).sum(dim=0, dtype=torch.int32)
    ndrop = torch.stack([o[4].to(home) for o in outs]).sum(dtype=torch.int32)
    n_over = stats[:, C + wpad + 1].view(nd, nr)
    oc = torch.stack([o[2].to(home) for o in outs]).view(nd, nr, capO)
    of = torch.stack([o[3].to(home) for o in outs]).view(nd, nr, capO)
    return counts, aw, ok, hist, ndrop, n_over, oc, of


# ---------------------------------------------------------------------------
# color-sharded sorted-stream query (shard-placed v3/v4 indexes,
# `build --color-shards N`)
# ---------------------------------------------------------------------------
#
# An index of more than 1024 colors is wider than the probe kernel, but each
# shard of a ("data", "color") mesh holds a <= 1024-color slice of every
# row. With the blocked placement sized to the SHARD's packed width
# (index.place_rpb == 128 // shard wpad), every shard runs the probe kernel
# locally in RAW mode (per-probe nhits / colorsum / hash presence out,
# counts in the kernel). The global epilogue needs two cross-shard facts
# per probe: the total hit count (uniqueness spans all colors) and per-hash
# row presence (a row is absent only if ALL shards see zeros). The uniq-hit
# frequency histogram then accumulates on the OWNING shard.


def stream_batch_colorshard(
    mat, blk, offp, qc, *, mesh, wpad, num_hash, rpb, Cl, cp, cap
):
    """Sorted-stream query over a ("data", "color") mesh for shard-placed
    indexes. blk/offp/qc are int32 [P] global sorted probes (qc == 0 marks
    padding; P a multiple of n_data * PC); every color shard sees the same
    probes. Returns per-shard counts int32 [S, 32 * wpad], and-words int32
    [S, wpad], ok, hist int32 [S, cp, FREQ_CAP], n_dropped, and the
    per-shard overflow lists n_over [nd, S], oc/of [nd, S, cap] (oc holds
    shard-local colors: the caller adds the shard's base)."""
    from ..ops.stream_query import stream_raw_local

    S = mesh.shape["color"]
    nd = mesh.n_data
    home = mesh.home
    hw = FREQ_CAP
    full = (1 << num_hash) - 1
    devs = [mesh.device(s) for s in range(S)]
    counts32 = [torch.zeros(32 * wpad, dtype=torch.int64, device=dv) for dv in devs]
    hist = [torch.zeros(cp * hw, dtype=torch.int32, device=dv) for dv in devs]
    n_valid = torch.zeros((), dtype=torch.int64, device=home)
    bad = torch.zeros((), dtype=torch.int64, device=home)
    ndrop = torch.zeros((), dtype=torch.int32, device=home)
    n_over, oc, of = [], [], []
    for d, sl in enumerate(_data_slices(blk.shape[0], nd)):
        local = []
        nh_g = seen = None
        for s in range(S):
            dv = mesh.device(s, d)
            b, o, q = (x[sl].to(dv).contiguous() for x in (blk, offp, qc))
            counts_l, nh_l, cs_l, pm_l, nd_l = stream_raw_local(
                _shard(mat, s, d), b, o, q, wpad=wpad, num_hash=num_hash, rpb=rpb,
                n_colors=Cl,
            )
            counts32[s] += counts_l.to(devs[s])
            ndrop += nd_l.to(home)
            local.append((q, nh_l, cs_l))
            nh, pm = nh_l.to(home), pm_l.to(home)
            nh_g = nh if nh_g is None else nh_g + nh
            seen = pm if seen is None else seen | pm
        realm = qc[sl].to(home) > 0
        present = seen == full
        validp = present & realm
        n_valid += validp.sum()
        bad += (realm & ~present).sum()
        uniq = validp & (nh_g == 1)
        for s in range(S):
            q, nh_l, cs_l = local[s]
            P = q.shape[0]
            dv = q.device
            owner = uniq.to(dv) & (nh_l == 1)
            spread = torch.arange(P, device=dv)
            # uniq-hit frequency histogram of the probes this shard owns
            sel = owner & (q < hw)
            hidx = torch.where(sel, cs_l.to(torch.int64) * hw + q, spread % (cp * hw))
            hist[s].index_add_(0, hidx.to(devs[s]), sel.to(torch.int32).to(devs[s]))
            # frequencies the histogram does not cover: the first cap of
            # them, in probe order
            big = owner & (q >= hw)
            n_big = big.sum()
            pos = torch.cumsum(big, dim=0) - 1
            keep = big & (pos < cap)
            oidx = torch.where(keep, pos, spread % cap)
            oc_l = torch.zeros(cap, dtype=torch.int32, device=dv)
            of_l = torch.zeros(cap, dtype=torch.int32, device=dv)
            oc_l.index_add_(0, oidx, torch.where(keep, cs_l, 0))
            of_l.index_add_(0, oidx, torch.where(keep, q, 0))
            n_over.append(n_big.clamp(max=cap).to(home))
            ndrop += (n_big - cap).clamp(min=0).to(torch.int32).to(home)
            oc.append(oc_l.to(home))
            of.append(of_l.to(home))
    and_b = torch.stack([
        _to_i32(_and_words(counts32[s], n_valid.to(devs[s]), wpad)).to(home)
        for s in range(S)
    ])
    return (
        torch.stack([c.to(home) for c in counts32]).to(torch.int32),
        and_b,
        (bad == 0).to(torch.int32),
        torch.stack([h.to(home) for h in hist]).view(S, cp, hw),
        ndrop,
        torch.stack(n_over).view(nd, S).to(torch.int32),
        torch.stack(oc).view(nd, S, cap),
        torch.stack(of).view(nd, S, cap),
    )


# ---------------------------------------------------------------------------
# sharded device extraction (search_reads on a mesh)
# ---------------------------------------------------------------------------


def extract_merge_datashard(reads, lens, *, mesh, k, L, filter_t, d=1):
    """Device extraction and a global unique/count/filter over the data
    axis. reads int32 [R, ceil(L/16)] (2-bit words), lens int32 [R], R a
    multiple of n_data.

    Each data slice counts its own reads' canonical windows
    (ops/extract.py::extract_count, no filter); the per-slice sets then
    merge on the home device: concatenated, sorted once (kernel G, the counts
    as its payload), the counts of a key summed over its whole run, the
    strictly-greater filter applied (the reference counts over the whole
    fastq before it filters, batch_search_pe.rs:28-39, so a per-slice filter
    would change the result). Slice s owns the sorted array's entries
    [s * T, (s + 1) * T), T = R * (L - k + 1) / n_data, and keeps the keys
    whose run starts there, compacted to the front. Returns (keys int32 [n_data * T, 2]
    (the (lo, hi) bit views), qcounts int32 [n_data * T] (0 = padding),
    n_owned int32 [n_data]).

    A mesh across processes has one data row: every rank extracts the same
    reads and needs no collective, as every JAX device of one data slice
    does on a P("data") input."""
    nd = mesh.n_data
    home = mesh.home
    keys, qcs = [], []
    for sl in _data_slices(reads.shape[0], nd):
        pk, qc, _n = extract_count(reads[sl], lens[sl], k=k, L=L, filter_t=0, d=d)
        pk = pk.to(torch.int64) & M32
        # the slice's padding slots (qc == 0) sort last, as (2^32-1, 2^32-1)
        keys.append(torch.where(qc == 0, SENT_KEY, _sort_key(pk[:, 0], pk[:, 1])).to(home))
        qcs.append(qc.to(home))
    # each slice is one sorted run (its kept keys, then SENT): kernel G merges
    s, q = value_sort(torch.cat(keys), torch.cat(qcs), bits=2 * k, runs=True)
    q = q.to(torch.int64)
    N = s.shape[0]
    new = torch.ones(N, dtype=torch.bool, device=home)
    new[1:] = s[1:] != s[:-1]
    # run totals over the WHOLE sorted array, before it is cut into slices:
    # a run may straddle a slice boundary, and the slice holding its first
    # entry keeps it
    run = torch.cumsum(new, dim=0) - 1
    total = torch.zeros(N, dtype=torch.int64, device=home).index_add_(0, run, q)[run]
    keep = new & (s != SENT_KEY) & (total > filter_t)
    lo, hi = _key_limbs(s)
    pk = torch.stack([_to_i32(lo), _to_i32(hi)], dim=1)
    T = N // nd
    keys_out, qc_out, n_owned = [], [], []
    for sl in _data_slices(N, nd):
        kp = keep[sl]
        to = torch.where(kp, torch.cumsum(kp, dim=0) - 1, T)  # slot T: dropped
        keys_out.append(
            torch.zeros((T + 1, 2), dtype=torch.int32, device=home).index_copy_(0, to, pk[sl])[:T])
        qc_out.append(
            torch.zeros(T + 1, dtype=torch.int32, device=home)
            .index_copy_(0, to, total[sl].to(torch.int32))[:T])
        n_owned.append(kp.sum())
    return (torch.cat(keys_out), torch.cat(qc_out),
            torch.stack(n_owned).to(torch.int32))


def hash_packed_datashard(keys2, *, mesh, k, num_hash, bloom_size, rpb_place=0, bv=1):
    """Bloom rows int32 [N, H] of packed k-mers int32 [N, 2] hashed on the
    device, slice by slice of the data axis (ops/hash_torch.py::
    device_rows; rpb_place / bv = the index's build-time placement). On a
    mesh across processes (one data row) every rank hashes the same
    k-mers, with no collective."""
    return torch.cat([
        _rows_from_packed(keys2[sl], k, num_hash, bloom_size, rpb_place, bv)
        for sl in _data_slices(keys2.shape[0], mesh.n_data)
    ])


# ---------------------------------------------------------------------------
# sharded read classifier (the read_id hot loop on a mesh)
# ---------------------------------------------------------------------------
#
# Reads split over the data axis in contiguous groups (the reference's rayon
# par_iter over reads, read_id_mt_pe.rs:300-361): rows / seg / pos are
# [n_data, Nl, ...], seg relative to the slice's first read, pos the
# k-mer's FnvHashSet iteration rank (PAD_POS on padding). A k-mer's
# presence (the break condition) is global: on the color layout a row is
# present where some shard's slice of it is nonzero, on the row layout it
# is present on the shard that owns it. Everything per color (the counts,
# the -B candidate set, the first hits) is shard-local on the color layout.


def _rows_from_packed(keys2, k, num_hash, bloom_size, rpb_place, bv):
    return device_rows(keys2, k=k, num_hash=num_hash, bloom_size=bloom_size,
                       rpb=rpb_place, version=bv)


def _readid_color(mat, rows_of, seg, pos, *, mesh, wpad, Wl, start_sample,
                  n_reads_l, rpb, firsthit):
    """(per-read color facts [n_data * n_reads_l, n_model * 32 * Wl], per
    read the no-hits flag, or with ``firsthit`` the first-absent position)
    on a ("data", "color") mesh; rows_of(d) gives data slice d's rows."""
    home = mesh.home
    per_read = _firsthit_report if firsthit else _readid_report
    cols_all, last = [], []
    for d in range(mesh.n_data):
        sg, ps = seg[d].to(home), pos[d].to(home)
        andw, present = _color_and_present(mat, rows_of(d), mesh, wpad, Wl, rpb, d)
        first_absent, counted = _first_absent(present, sg, ps, n_reads_l)
        cols = []
        for a in andw:
            dev = a.device
            cols.append(per_read(
                _unpack_bits(a, 32 * Wl), counted.to(dev), sg.to(dev), ps.to(dev),
                n_reads_l, start_sample,
            ).to(home))
        cols_all.append(torch.cat(cols, dim=1))
        last.append(first_absent if firsthit else (first_absent < BIG).to(torch.int32))
    return torch.cat(cols_all), torch.cat(last)


def _readid_row(mat, rows_of, seg, pos, *, mesh, wpad, Rl, W, start_sample,
                n_reads_l, rpb, firsthit):
    """_readid_color on a ("data", "row") mesh: the partial ANDs and
    presences merge over the row shards (and over the ranks of a mesh
    across processes), then the per-read logic runs once per data slice on
    the home device."""
    home = mesh.home
    per_read = _firsthit_report if firsthit else _readid_report
    cols_all, last = [], []
    for d in range(mesh.n_data):
        sg, ps = seg[d].to(home), pos[d].to(home)
        andw, present = _row_and_present(mat, rows_of(d), mesh, wpad, Rl, W, rpb, d)
        first_absent, counted = _first_absent(present, sg, ps, n_reads_l)
        cols_all.append(per_read(_unpack_bits(andw, 32 * W), counted, sg, ps,
                                 n_reads_l, start_sample))
        last.append(first_absent if firsthit else (first_absent < BIG).to(torch.int32))
    return torch.cat(cols_all), torch.cat(last)


def readid_batch_colorshard(matrix, rows, seg, pos, *, mesh, wpad, Wl,
                            start_sample, n_reads_l, rpb=0):
    """ops/query.py::query_readid_batch on a ("data", "color") mesh. rows
    int32 [n_data, Nl, H]; seg, pos int32 [n_data, Nl]. Returns (report
    int32 [n_data * n_reads_l, n_model * 32 * Wl], no_hits int32
    [n_data * n_reads_l])."""
    return _readid_color(
        matrix, lambda d: rows[d], seg, pos, mesh=mesh, wpad=wpad, Wl=Wl,
        start_sample=start_sample, n_reads_l=n_reads_l, rpb=rpb, firsthit=False,
    )


def readid_batch_rowshard(matrix, rows, seg, pos, *, mesh, wpad, Rl, W,
                          start_sample, n_reads_l, rpb=0):
    """query_readid_batch on a ("data", "row") mesh. Returns (report int32
    [n_data * n_reads_l, 32 * W], no_hits int32 [n_data * n_reads_l])."""
    return _readid_row(
        matrix, lambda d: rows[d], seg, pos, mesh=mesh, wpad=wpad, Rl=Rl, W=W,
        start_sample=start_sample, n_reads_l=n_reads_l, rpb=rpb, firsthit=False,
    )


def readid_batch_colorshard_packed(matrix, keys2, seg, pos, *, mesh, wpad, Wl,
                                   start_sample, n_reads_l, rpb, k, num_hash,
                                   bloom_size, rpb_place, bv):
    """readid_batch_colorshard with the rows hashed on the device from
    2-bit packed k-mers int32 [n_data, Nl, 2] (12 B of host traffic per
    k-mer)."""
    return _readid_color(
        matrix,
        lambda d: _rows_from_packed(keys2[d], k, num_hash, bloom_size, rpb_place, bv),
        seg, pos, mesh=mesh, wpad=wpad, Wl=Wl, start_sample=start_sample,
        n_reads_l=n_reads_l, rpb=rpb, firsthit=False,
    )


def readid_batch_rowshard_packed(matrix, keys2, seg, pos, *, mesh, wpad, Rl, W,
                                 start_sample, n_reads_l, rpb, k, num_hash,
                                 bloom_size, rpb_place, bv):
    """readid_batch_rowshard with the rows hashed on the device."""
    return _readid_row(
        matrix,
        lambda d: _rows_from_packed(keys2[d], k, num_hash, bloom_size, rpb_place, bv),
        seg, pos, mesh=mesh, wpad=wpad, Rl=Rl, W=W, start_sample=start_sample,
        n_reads_l=n_reads_l, rpb=rpb, firsthit=False,
    )


def readid_firsthit_colorshard(matrix, rows, seg, pos, *, mesh, wpad, Wl,
                               start_sample, n_reads_l, rpb=0):
    """ops/query.py::query_readid_firsthit on a ("data", "color") mesh.
    Returns (fh int32 [n_data * n_reads_l, n_model * 32 * Wl], first_absent
    int32 [n_data * n_reads_l]); BIG where never."""
    return _readid_color(
        matrix, lambda d: rows[d], seg, pos, mesh=mesh, wpad=wpad, Wl=Wl,
        start_sample=start_sample, n_reads_l=n_reads_l, rpb=rpb, firsthit=True,
    )


def readid_firsthit_rowshard(matrix, rows, seg, pos, *, mesh, wpad, Rl, W,
                             start_sample, n_reads_l, rpb=0):
    """query_readid_firsthit on a ("data", "row") mesh. Returns (fh int32
    [n_data * n_reads_l, 32 * W], first_absent int32 [n_data * n_reads_l])."""
    return _readid_row(
        matrix, lambda d: rows[d], seg, pos, mesh=mesh, wpad=wpad, Rl=Rl, W=W,
        start_sample=start_sample, n_reads_l=n_reads_l, rpb=rpb, firsthit=True,
    )
