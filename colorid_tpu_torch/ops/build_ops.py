"""Index construction on the device: the scatter-OR of the build.

The reference builds per-accession Bloom filters, then transposes them by
scanning every Bloom row across all filters (build.rs:167-244). The dense
layout needs no transpose: each accession's Bloom rows OR its color's bit
into word c // 32 of those rows of the [bloom_size, W] matrix, in place on
the device.

Words are uint32 bit patterns in int32 tensors (torch has no uint32
arithmetic on the CPU): bit 31 is the int32 sign bit, so the word of color
c % 32 == 31 is negative where it is set.

Row lists are host arrays, checked against the matrix height on the host:
an out-of-range index in a CUDA index_put_ is a device-side assert, and
torch has no drop mode, so nothing is padded (the JAX package pads its row
lists with the dropped index R only to bound its compile cache).

A row-sharded build (build_matrix_rowshard) gives each row shard of a
("data", "row") mesh only the rows it owns; the full matrix then never
exists on the host or in one tensor, and pack_blocks_rowshard packs each
shard for the sharded engine (parallel/engine.py, ``sharded_matrix=``). On
a mesh across processes each process builds only the shards it holds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime import resolve_device
from .query import row_wpad


def _bit_value(bit: int) -> int:
    """The int32 value of the word with only ``bit`` (0..31) set."""
    return (1 << bit) - (1 << 32 if bit == 31 else 0)


def scatter_or_column(acc: torch.Tensor, rows: torch.Tensor, bit: int) -> torch.Tensor:
    """OR bit ``bit`` into acc[rows], in place; returns acc.

    acc: int32 [R] packed word column (a column view of a matrix works);
    rows: integer [M] Bloom rows in [0, R), repeats allowed (every repeat
    writes the same word, so the result does not depend on which one
    lands)."""
    rows = rows.to(acc.device).to(torch.int64)  # cross the link narrow
    acc.index_put_((rows,), acc[rows] | _bit_value(bit))
    return acc


def _checked_rows(rows, bloom_size: int) -> np.ndarray:
    """One accession's Bloom rows as a flat host array of their own integer
    type, refused if any lies outside [0, bloom_size)."""
    r = np.asarray(rows).ravel()
    if r.size and (int(r.min()) < 0 or int(r.max()) >= bloom_size):
        raise ValueError(
            f"Bloom rows must lie in [0, {bloom_size}); got "
            f"[{int(r.min())}, {int(r.max())}]"
        )
    return r


def build_matrix_device(
    row_lists: list[np.ndarray],
    bloom_size: int,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """The [bloom_size, W] matrix built on ``device`` from per-accession
    Bloom rows (accession i = color i). Returns int32 [bloom_size, W] (the
    bit view of the uint32 words)."""
    dev = resolve_device(device)
    C = len(row_lists)
    W = (C + 31) // 32
    mat = torch.zeros((bloom_size, W), dtype=torch.int32, device=dev)
    for c, rl in enumerate(row_lists):
        rows = torch.from_numpy(_checked_rows(rl, bloom_size))
        scatter_or_column(mat[:, c // 32], rows, c % 32)
    return mat


def build_matrix_rowshard(
    row_lists: list[np.ndarray],
    bloom_size: int,
    mesh,
    *,
    row_multiple: int,
):
    """Row-sharded build for indexes beyond one device's memory: shard r of
    the mesh's "row" axis owns rows [r * Rl, (r + 1) * Rl) and ORs only
    those (the host cuts each accession's sorted rows at the shard
    boundaries, so each device receives its own). Rl = ceil(bloom_size / n)
    rounded up to ``row_multiple``: the sharded engine's
    ShardedQueryEngine.row_multiple(index), or 1 for the JAX package's
    unrounded shards.

    Returns (shards, Rl): a list of n int32 [Rl, W] tensors, shard r on
    mesh.device(r); rows past bloom_size stay zero. On a mesh across
    processes every rank passes the same row lists and scatters only the
    shards it holds; the others are None."""
    if mesh.model_axis != "row":
        raise ValueError(f"a row-sharded build needs a row mesh; got {mesh.model_axis!r}")
    n = mesh.n_model
    W = (len(row_lists) + 31) // 32
    Rl = -(-bloom_size // n)
    Rl = -(-Rl // row_multiple) * row_multiple
    shards = [
        torch.zeros((Rl, W), dtype=torch.int32, device=mesh.device(r))
        if mesh.owns(r) else None
        for r in range(n)
    ]
    for c, rl in enumerate(row_lists):
        rows = _checked_rows(rl, bloom_size)
        if rows.size > 1 and not (rows[1:] >= rows[:-1]).all():
            rows = np.sort(rows)  # a build's own lists (np.nonzero) are sorted
        cuts = np.searchsorted(rows, np.arange(1, n) * Rl)
        for r, local in enumerate(np.split(rows, cuts)):
            if local.size and shards[r] is not None:
                scatter_or_column(
                    shards[r][:, c // 32], torch.from_numpy(local - r * Rl), c % 32
                )
    return shards, Rl


def pack_blocks_rowshard(mat: list[torch.Tensor], *, mesh, Rl: int, W: int):
    """Pack each [Rl, W] row shard into the block-gather layout on its own
    device: the blocks parallel/sharded.py::device_put_rowshard gives for
    the gathered matrix (rows padded to row_wpad(W) words, at least 512
    blocks as in pack_matrix_blocks), without gathering it. Returns a list
    of int32 [nb, 128] tensors, shard r on mesh.device(r) (None where
    ``mat`` has None: a shard another process holds)."""
    if len(mat) != mesh.n_model:
        raise ValueError(f"{len(mat)} shards for a mesh of {mesh.n_model} row shards")
    wpad = row_wpad(W)
    nb = max(-(-(Rl * wpad) // (128 * 128)) * 128, 512)
    cap = -(-(nb * 128) // wpad)
    out = []
    for r, m in enumerate(mat):
        if m is None:
            out.append(None)
            continue
        if m.shape != (Rl, W):
            raise ValueError(f"shard {r} is {list(m.shape)}, not [{Rl}, {W}]")
        mp = torch.zeros((cap, wpad), dtype=torch.int32, device=mesh.device(r))
        mp[:Rl, :W] = m
        out.append(mp.reshape(-1)[: nb * 128].reshape(nb, 128))
    return out
