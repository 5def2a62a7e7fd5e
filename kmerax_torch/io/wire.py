"""2-bit host<->device wire for read batches (port of kmerax/io/wire.py;
DESIGN.md §11b).

The int8 wire carries one base per byte. This one packs four 2-bit base
codes per byte:

  H2D: the host packs (B, L) base codes -> (B, ceil(L/4)) uint8; the device
       unpacks them and rebuilds the padding (code 4) from `lengths`, so
       the stages downstream see exactly the (B, L) rows padded with 4 that
       the int8 wire gives.
  D2H: the corrected batch packs on the device to (B, ceil(L/4)) uint8 and
       the host unpacks it; the FASTQ writer reads only row[:length], and
       within a length an N-free batch holds only codes 0..3.

N (code 4) does not fit in 2 bits, so a batch with an N inside a read
crosses as int8 (`batch_has_n`); output bytes are the same on both wires.

A stage sends its batches through `to_device_batch` (count, correct,
align): `send_batch` is the H2D leg, `unwire` the device unpack. The wire
is decided for the whole batch, so a mesh rank that sends only its rows
takes the wire every rank of it takes.

The device side shifts and masks in uint8 (torch has uint8 shifts on the
CPU, unlike uint32 ones), so its temporaries are a byte a base.
"""

from __future__ import annotations

import numpy as np
import torch


def packed_cols(L: int) -> int:
    """Wire columns for L bases: ceil(L/4)."""
    return (L + 3) // 4


def batch_has_n(bases: np.ndarray, lengths: np.ndarray) -> bool:
    """True iff some base inside a read is code 4 (N).

    Rows are padded past `lengths` with 4 (io/batcher.py), so the batch is
    N-free exactly when the number of 4s equals the padding count.
    """
    n_four = int((bases == 4).sum())
    n_pad = bases.shape[0] * bases.shape[1] - int(lengths.sum())
    return n_four != n_pad


def pack2_host(bases: np.ndarray) -> np.ndarray:
    """(B, L) codes -> (B, ceil(L/4)) uint8, 4 bases a byte, first base in
    the low bits. Codes >= 4 (padding) pack as their low bits; the device
    unpack restores them from `lengths`, so only N-free batches may use
    this (`batch_has_n`)."""
    B, L = bases.shape
    L4 = packed_cols(L) * 4
    b = bases.astype(np.uint8) & 3
    if L4 != L:
        b = np.concatenate([b, np.zeros((B, L4 - L), np.uint8)], axis=1)
    b = b.reshape(B, L4 // 4, 4)
    return (b[:, :, 0] | (b[:, :, 1] << 2) | (b[:, :, 2] << 4)
            | (b[:, :, 3] << 6))


def _shifts(device) -> torch.Tensor:
    return torch.arange(0, 8, 2, dtype=torch.uint8, device=device)


def unpack2_dev(packed: torch.Tensor, lengths: torch.Tensor,
                L: int) -> torch.Tensor:
    """Device unpack: (B, ceil(L/4)) uint8 -> (B, L) int8, padding rebuilt
    as 4 past `lengths` (the rows the int8 wire gives)."""
    B, dev = packed.shape[0], packed.device
    b = ((packed[:, :, None] >> _shifts(dev)) & 3).view(B, -1)[:, :L]
    pos = torch.arange(L, dtype=torch.int32, device=dev)
    return torch.where(pos[None, :] < lengths[:, None], b, 4) \
        .view(torch.int8)


def pack2_dev(bases: torch.Tensor) -> torch.Tensor:
    """Device pack: (B, L) codes -> (B, ceil(L/4)) uint8. Values >= 4
    (padding past a length) pack as their low bits; the host reads only
    row[:length]."""
    B, L = bases.shape
    L4 = packed_cols(L) * 4
    b = bases.to(torch.uint8) & 3
    if L4 != L:
        b = torch.nn.functional.pad(b, (0, L4 - L))
    return (b.view(B, L4 // 4, 4) << _shifts(bases.device)).sum(
        -1, dtype=torch.uint8)


def unpack2_host(packed: np.ndarray, L: int) -> np.ndarray:
    """Host unpack: (B, ceil(L/4)) uint8 -> (B, L) uint8 codes 0..3.
    Positions past a read's length hold the padding's low bits; callers
    slice to the length, as with the int8 wire."""
    p = packed[:, :, None]
    shifts = (np.arange(4, dtype=np.uint8) * 2)[None, None, :]
    b = (p >> shifts) & 3
    return b.reshape(packed.shape[0], -1)[:, :L]


def send_batch(batch, device, pack: bool = False, rows=None):
    """The H2D leg of a host ReadBatch -> (rows, int32 lengths (B,),
    packed) on the device. With `pack`, an N-free batch crosses on the 2-bit
    wire (rows (B, ceil(L/4)) uint8) and `packed` is True; otherwise the
    rows are the (B, L) int8 bases. With `rows` (a slice), only those rows
    cross, on the wire the whole batch takes."""
    bases, lengths = batch.bases, batch.lengths
    pack = pack and not batch_has_n(bases, lengths)
    if rows is not None:
        bases, lengths = bases[rows], lengths[rows]
    lengths = torch.from_numpy(lengths).to(device)
    if pack:
        return torch.from_numpy(pack2_host(bases)).to(device), lengths, True
    return (torch.from_numpy(bases.astype(np.int8)).to(device), lengths,
            False)


def unwire(rows, lengths, packed: bool, L: int):
    """The device leg: send_batch's rows -> (B, L) int8 bases."""
    return unpack2_dev(rows, lengths, L) if packed else rows


def to_device_batch(batch, device, pack: bool = False, rows=None):
    """A host ReadBatch (or its `rows`) -> (int8 bases (B, L), int32
    lengths (B,), packed) on the device: send_batch, then the unpack on the
    2-bit wire."""
    sent, lengths, packed = send_batch(batch, device, pack, rows)
    return (unwire(sent, lengths, packed, batch.bases.shape[1]), lengths,
            packed)
