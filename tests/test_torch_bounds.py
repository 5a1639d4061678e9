"""The byte accounting behind chip_smoke.py's kernel bounds (the least time
the card could take: bytes over the memory rate), on tiny cases counted by
hand. The bounds run on CPU tensors as on the card's."""

import torch

import chip_smoke as cs


def _i32(*v):
    return torch.tensor(v, dtype=torch.int32)


def test_sectors_of_narrow_and_wide_rows():
    starts = torch.tensor([0, 1, 7, 8, 100], dtype=torch.int64)
    assert cs.sectors(starts, 1) == 3  # words 0-7, 8-15 and 96-103
    # rows of 32 words start at multiples of 32 and cover 4 sectors each
    assert cs.sectors(torch.tensor([0, 32, 32, 96]), 32) == 3 * 4


def test_classic_bytes_counts_rows_words_tb_and_sectors():
    row_s = _i32(0, 1, 7, 8, 9, 100, 70_000)
    inwin = torch.tensor([True] * 6 + [False])  # the last row is read elsewhere
    n_bytes, n_sectors = cs.classic_bytes(row_s, inwin, 1)
    assert n_sectors == 3  # rows 0-7, 8-15 and 96-103
    assert n_bytes == 7 * (4 + 4) + 1 * 4 + 3 * 32
    # the coarser count: 12 bytes per probe, tb, 4 bytes per distinct word
    assert cs.classic_bytes_by_word(row_s, 1) == 7 * 12 + 4 + 7 * 4
    assert cs.classic_bytes_by_word(_i32(5, 5, 6, 6), 1) == 4 * 12 + 4 + 2 * 4


def test_raw_bytes_at_wpad_32_count_four_sectors_a_row():
    # two hashes, 8 bits of in-block row offset each; a row is 32 words
    blk = _i32(0, 0, 1, 3)
    off = _i32(0 | 1 << 8, 0 | 2 << 8, 3 | 0 << 8, 1 | 1 << 8)
    qc = _i32(1, 5, 0, 2)  # the third probe is not counted: its rows are not read
    n_bytes, n_sectors = cs.probe_bytes(blk, off, qc, 32, 2, 24, 1024)
    # rows at words 0, 32, 64 (block 0) and 416 (block 3, row 1, twice)
    assert n_sectors == 4 * 4
    assert n_bytes == 4 * 24 + 16 * 32 + 2 * 4 * 1024


def test_probe_bytes_at_wpad_1_share_sectors():
    # four hashes of one-word rows: rows 0-7 of a block share a sector
    blk = _i32(2, 2)
    off = _i32(0 | 3 << 8 | 9 << 16 | 127 << 24, 1 | 2 << 8 | 4 << 16 | 5 << 24)
    qc = _i32(1, 1)
    n_bytes, n_sectors = cs.probe_bytes(blk, off, qc, 1, 4, 16, 32 + 32 * 1024)
    # block 2's sectors of rows 0-7, 8-15 and 120-127
    assert n_sectors == 3
    assert n_bytes == 2 * 16 + 3 * 32 + 2 * 4 * (32 + 32 * 1024)


def test_stream_tail_bytes_from_the_sort_and_from_sorted_probes():
    """Kernel D's bytes for 4,096 probes in two chunks of 2,048 (two tiles),
    W 1, C 21, hw 1,024, one slot of the residual list: from the int32 key
    with the frequency in it that kernel E sorted with its payloads (the key
    read, blk_s, qc_s and qcw written; the offsets and the index came from
    the sort), three residual probes on two sectors and one kept overflow
    entry; and the same batch sorted already (the block sorted alone, the
    frequency an operand), in exact mode, with nothing listed."""
    P, pc = 4096, 2048
    d2 = (8 * P + 4 * (32 + 21 * 1024) + 8 * 21 * 1024 + 8 * 24 + 4 * 1 + 12 + 4)
    keyed = cs.stream_tail_bytes(P, pc=pc, n_slots=1, n_listed=1, W=1, C=21, hw=1024,
                                 key_bytes=4, n_res=3, res_sectors=2, n_kept=1)
    d1 = P * (4 + 8 + 4) + 4 * 1 + 12
    gather = pc * (4 + 10) + 8 * pc + 12 * 3 + 32 * 2
    assert keyed == d1 + d2 + 20 + gather
    sorted_ = cs.stream_tail_bytes(P, pc=pc, n_slots=1, n_listed=0, W=1, C=21, hw=1024,
                                   key_bytes=0, n_res=0, res_sectors=0, n_kept=0)
    assert sorted_ == P * (8 + 4) + 4 + 12 + d2 + pc * (4 + 10)


def test_stream_tail_bytes_of_the_five_launch_design():
    """The count that kernel D's five-launch design was held to (printed
    beside the new one): the chunks' tb and counts written and read, the
    tiles' counts written and read, the list written, blk_s and qc_s read a
    row of a listed chunk and the offsets and payload a residual probe."""
    P, pc = 4096, 2048
    d2 = 8 * P + 4 * (32 + 21 * 1024) + 8 * 21 * 1024 + 8 * 24 + 8 * 2 + 16 * 2 + 4 * 1
    keyed = cs.stream_tail_bytes_five_launches(
        P, pc=pc, n_slots=1, n_listed=1, W=1, C=21, hw=1024, key_bytes=4, n_res=3,
        res_sectors=2, n_kept=1)
    d1 = P * (4 + 8) + P * 4 + 12 * 2
    d3 = pc * (4 + 10) + 8 * pc + 8 * 3 + 32 * 2
    assert keyed == d1 + d2 + 20 + d3
    sorted_ = cs.stream_tail_bytes_five_launches(
        P, pc=pc, n_slots=1, n_listed=0, W=1, C=21, hw=1024, key_bytes=0, n_res=0,
        res_sectors=0, n_kept=0)
    assert sorted_ == P * 8 + P * 4 + 12 * 2 + d2 + pc * (4 + 10)


def test_sort_bytes_read_each_input_and_write_each_output_once():
    """Kernel E's bytes: 16 a probe for the blocked exact key with its
    offsets, and for the classic rows with an int64 index (not read: made
    in the first pass); 20 for the clipped key, its offsets and an int32
    index; 24 with qbits 0 (key, offsets, frequencies)."""
    P = 9_437_184
    assert cs.sort_bytes(P, n_operands=1, index=False, index64=False) == 16 * P
    assert cs.sort_bytes(34_603_008, n_operands=0, index=True, index64=True) == 16 * 34_603_008
    assert cs.sort_bytes(P, n_operands=1, index=True, index64=False) == 20 * P
    assert cs.sort_bytes(P, n_operands=2, index=False, index64=False) == 24 * P


def test_run_counts_bytes_read_the_keys_once_and_write_each_mode_once():
    P = 4096
    # select: the keys, then keys and counts of P >> rounds slots (counts
    # alone at 0 rounds: the keys pass through), and n_unique
    assert cs.run_counts_bytes(P, mode="select") == 8 * P + 4 * P + 4
    assert cs.run_counts_bytes(P, mode="select", rounds=1) == 8 * P + 12 * (P // 2) + 4
    assert cs.run_counts_bytes(P, mode="select", rounds=3) == 8 * P + 12 * (P // 8) + 4
    # with weights, select also reads the int32 weights
    assert cs.run_counts_bytes(P, mode="select", weights=True) == 12 * P + 4 * P + 4
    # partition reads every weight (liveness) but only the keys it writes
    assert cs.run_counts_bytes(P, mode="partition", cap=100) == 4 * P + 20 * 100 + 4
    assert cs.run_counts_bytes(P, mode="partition", cap=10 * P) == 4 * P + 20 * P + 4
    assert cs.run_counts_bytes(P, mode="partition", weights=True, cap=100) == (
        4 * P + 20 * 100 + 4)
    # compact writes the limbs and counts of every slot, the zero tail too
    assert cs.run_counts_bytes(P, mode="compact") == 8 * P + 12 * P + 4


def test_value_sort_bytes_reads_and_writes_each_key_once():
    """Kernel G's bound: the int64 keys read and written once (16 bytes a
    key), the int32 payload too where there is one (24); the single
    route's 52,002,816 keys are 832,045,056 bytes."""
    assert cs.value_sort_bytes(1, payload=False) == 16
    assert cs.value_sort_bytes(3, payload=True) == 3 * 24
    assert cs.value_sort_bytes(0, payload=True) == 0
    assert cs.value_sort_bytes(52_002_816, payload=False) == 832_045_056


def test_readid_bytes_count_keys_row_sectors_and_the_output():
    """Kernel H's order-free pass on 2 reads of 3 windows (24 bytes of keys
    each) whose distinct valid k-mers have one-word rows at words 0, 5, 9
    and 9 (sectors 0-7 and 8-15), C 21 (24 output columns a read); and the
    replay on 5 k-mers of H 2 (8 + 4 + 4 bytes each) with 4-word rows at
    words 0, 4, 8, 64 (sectors 0-7, 8-15, 64-71), C 21 (22 columns)."""
    starts = torch.tensor([0, 5, 9, 9])
    n_bytes, n_sectors = cs.readid_bytes(6, 8, starts, 1, 2, 24)
    assert n_sectors == 2
    assert n_bytes == 6 * 8 + 2 * 32 + 2 * 24 * 4
    starts = torch.tensor([0, 4, 8, 64])
    n_bytes, n_sectors = cs.readid_bytes(5, 16, starts, 4, 3, 22)
    assert n_sectors == 3
    assert n_bytes == 5 * 16 + 3 * 32 + 3 * 22 * 4


def test_gather_bytes_count_real_rows_their_sectors_and_the_accumulators():
    # classic rows of one word: k-mers 0 and 1 share the sector of words 0-7,
    # k-mer 2 is padding (its rows are not read)
    rows = _i32(0, 3, 5, 9, 100, 200).view(3, 2)
    mask = torch.tensor([True, True, False])
    n_bytes, n_sectors = cs.gather_bytes(rows, mask, 1, 0, 5, n_kept=2)
    assert n_sectors == 2  # words 0-7 and 8-15
    acc = 2 * 4 * (5 + 1 + 2 + 5 * 1024)
    assert n_bytes == 3 * 5 + 4 * 4 + 2 * 32 + acc + 2 * 8
    # blocked rows of 32 words (rpb 4): both rows of a k-mer lie in the block
    # of its hash-0 row, 4 sectors each; int64 rows are 8 bytes a row
    rows = torch.tensor([[4, 5], [4, 7], [9, 8]], dtype=torch.int64)
    n_bytes, n_sectors = cs.gather_bytes(rows, torch.ones(3, dtype=torch.bool), 32, 4, 40, 0)
    # starts: block 1 lanes 0, 32 and 96; block 2 lanes 32 and 0
    assert n_sectors == 5 * 4
    assert n_bytes == 3 * 5 + 6 * 8 + 20 * 32 + 2 * 4 * (40 + 32 + 2 + 40 * 1024)


def test_row_ops_count_the_least_work_of_a_row():
    # a word: a popcount and a carry-save add (XOR, AND); gathering, also
    # the AND over its H rows' words and a nonzero test of each
    assert cs._row_ops(1) == 3
    assert cs._row_ops(8) == 8 * 3
    assert cs._row_ops(32, 4) == 32 * (3 + 3 + 4)
    assert cs._row_ops(1, 1) == 1 * (3 + 0 + 1)
