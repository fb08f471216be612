"""The one-hot matmul grouped reduction for small group spaces (the mm
strategy).

The port's counterpart of the reference package's `engine/mmagg.py`. Each
step of rows builds the int8 one-hot of (group key AND row mask), [G, rows],
once, and every aggregator contracts against it in two products:

  * int8 rows (the count row and <= 7-bit limbs of the long sums) x the
    one-hot, accumulating in int32 (`torch._int_mm`, cuBLASLt on the card):
    exact, since the reference's plan guards 127 x padded rows < 2^31;
    steps add into an int64 accumulator. The product runs block-diagonal
    (`int8_product`): with 8 value rows against a million one-hot columns
    (N = 8, K = 2^20) cuBLASLt read the one-hot at ~0.24 TB/s on the H100
    (4.55 ms a step), so the step's columns are cut into S slices, the
    one-hot viewed as [G * S, rows / S] against all S slices' value rows
    (N = S x 8 = 128), and each slice's own block taken off the diagonal:
    S times the operations, which the int8 tensor cores have to spare;
  * float32 rows holding the bf16 hi/lo/lo2 split of the float sums x the
    one-hot in float32: each part has <= 8 significant bits, so every
    product is exact and only the float32 accumulation rounds. The product
    runs at full float32 precision ("highest"), set around the call.

Long sums are rebuilt from their limbs in int64 (kernels.SumKernel.mm_plan).
There are no atomics: a step's products and the adds between steps run in a
fixed order, so float sums have the same bits from run to run.

Cost on the card. The one-hot is written once (a zero fill, then one scatter
of the mask into it) and read once by the product: 2 x G bytes a row, 2 KiB
a row at G = 1024, which bounds the step by bytes, not by the tensor cores.
A step covers `step_rows(G)` rows: a one-hot of at most MM_ONEHOT_BYTES
(1 GiB: 1,048,576 rows at G = 1024, so 12 steps for a 12.5M-row segment),
plus its float32 copy when the plan has float rows.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Sequence

import torch

from druid_tpu_torch.engine.kernels import AggKernel, MMPlan

MM_GROUP_LIMIT = 4096        # beyond this the N x G products dominate
MM_BLOCK = 8192              # rows per step are a multiple of this
#: bytes of one step's int8 one-hot (the step's largest buffer)
MM_ONEHOT_BYTES = 1 << 30
#: `torch._int_mm` on CUDA takes a first operand of more than 16 rows and
#: inner and output widths that are multiples of 8
_INT_MM_MIN_ROWS = 32
_INT_MM_ALIGN = 8
#: output width of the block-diagonal int8 product: slices x value rows
PRODUCT_WIDTH = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def step_rows(num_total: int) -> int:
    """Rows per step: the most whole MM_BLOCKs whose one-hot fits
    MM_ONEHOT_BYTES."""
    g = max(num_total, _INT_MM_MIN_ROWS)
    return max(MM_BLOCK, MM_ONEHOT_BYTES // g // MM_BLOCK * MM_BLOCK)


@contextmanager
def _f32_matmul_precision(precision: str):
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def onehot(key: torch.Tensor, mask: torch.Tensor, groups: int) -> torch.Tensor:
    """int8 [groups, rows]: 1 where the row is live and its key is the
    group. One zero fill and one scatter (each column holds one write)."""
    oh = torch.zeros(groups, key.shape[0], dtype=torch.int8,
                     device=key.device)
    return oh.scatter_(0, key.view(1, -1), mask.to(torch.int8).view(1, -1))


def slices(r8: int) -> int:
    """Column slices of the block-diagonal product for r8 value rows."""
    return max(1, PRODUCT_WIDTH // r8)


def int8_product(oh: torch.Tensor, lhs: torch.Tensor) -> torch.Tensor:
    """int64 [groups, r8]: the one-hot `oh` [groups, width] times the value
    rows, given as `lhs` [S, r8, width / S] (lhs[s] holds columns
    s * width / S onwards). One int8 product of [groups * S, width / S] by
    [width / S, S * r8]; block (s, s) of it is slice s's share."""
    s, r8, cw = lhs.shape
    groups = oh.shape[0]
    p = torch._int_mm(oh.view(groups * s, cw), lhs.view(s * r8, cw).t())
    return p.view(groups, s, s, r8).diagonal(dim1=1, dim2=2).sum(-1)


def _pad_cols(t: torch.Tensor, width: int) -> torch.Tensor:
    pad = width - t.shape[-1]
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def mm_reduce(arrays: Dict, mask: torch.Tensor, key: torch.Tensor,
              kernels: Sequence[AggKernel], plans: Sequence[MMPlan],
              num_total: int):
    """(counts int64 [num_total], per-kernel states). `key` int64 in
    [0, num_total), `mask` bool, both [n]; `arrays` is the dense view."""
    fields = sorted({f for p in plans for f in p.fields})
    cols = {f: arrays[f] for f in fields}
    n = mask.shape[0]
    dev = key.device
    groups = max(num_total, _INT_MM_MIN_ROWS)
    n_i8 = 1 + sum(p.n_i8 for p in plans)       # leading row: row counts
    n_bf = sum(p.n_bf16 for p in plans)
    r8 = _round_up(n_i8, _INT_MM_ALIGN)
    nsl = slices(r8)
    acc8 = torch.zeros(groups, r8, dtype=torch.int64, device=dev)
    accf = torch.zeros(groups, max(n_bf, 1), dtype=torch.float32, device=dev)
    step = step_rows(num_total)
    for s in range(0, n, step):
        e = min(n, s + step)
        width = _round_up(e - s, _INT_MM_ALIGN * nsl)
        kb = _pad_cols(key[s:e], width)
        mb = _pad_cols(mask[s:e], width)      # padding columns are masked
        cb = {f: _pad_cols(c[s:e], width) for f, c in cols.items()}
        oh = onehot(kb, mb, groups)
        lhs8 = torch.zeros(nsl, r8, width // nsl, dtype=torch.int8,
                           device=dev)
        lhs8[:, 0] = 1
        rowsf = []
        o = 1
        for p in plans:
            r8s, rfs = p.make_rows(cb, mb)
            for r in r8s:
                lhs8[:, o] = r.view(nsl, -1)
                o += 1
            rowsf.extend(rfs)
        acc8 += int8_product(oh, lhs8)
        if rowsf:
            with _f32_matmul_precision("highest"):
                accf += oh.to(torch.float32) @ torch.stack(rowsf, 0).t()
    counts = acc8[:num_total, 0]
    states = []
    o8, of = 1, 0
    for p in plans:
        states.append(p.finish(acc8[:num_total, o8:o8 + p.n_i8].t(),
                               accf[:num_total, of:of + p.n_bf16].t(),
                               num_total))
        o8 += p.n_i8
        of += p.n_bf16
    return counts, tuple(states)
