"""Grouped reduction over the sorted, key-compacted projection (kernel B1).

The port's counterpart of the reference package's `engine/pallas_agg.py`:
it replaces the TPU kernel `pallas_agg.pallas_reduce` (pl.pallas_call at
pallas_agg.py:400) with the hand-written CUDA kernel
`druid_tpu_torch/csrc/sorted_reduce.cu`. A value column is a dense
int32/float32 tensor or, where it staged packed (data/packed.py), its
tile-planar int32 words, which the kernel unpacks per row; packed and dense
give the same bits.

* `sorted_reduce` is the entry point: CPU tensors go to the plain PyTorch
  version, CUDA tensors to the kernel (or the call raises).
* `sorted_reduce_plain` computes the same function with torch scatter ops:
  the tests and the chip smoke hold the kernel against it.
* `LAUNCHES` counts the kernel's launches (one per `sorted_reduce_cuda`
  call, which runs the kernel's two passes); `PLAIN_CALLS` counts the CPU
  calls `sorted_reduce` routed to the plain version.
* `launch` runs the two passes for B1 and for kernel B2
  (engine/megakernel.py), which takes the row mask as int32 words instead
  of folding it into the keys; B2 counts its own launches.

Contract, as in the reference: (counts int32 [G], per-kernel states). For
every block of BLK rows the window starts at the block's minimum key aligned
down to 128 (clamped to [0, round_up(G,128)]) and spans W keys; rows outside
it are dropped, masked rows never count. Long sums are exact int64, counts
and min/max exact, float min/max propagate NaN. Float sums are summed in row
order within each thread's chunk of a block, across chunks in a tree fixed by
BLK and PARTIAL_THREADS, and in (window base, block) order across blocks, so
two runs give the same bits; they differ from the reference's tree order
within the tolerance of float32 summation.

Bound on an H100, as chip_smoke.py counts it: the bytes the function needs,
each once, over 3.35 TB/s: the whole row mask (n B of bools here, n / 8 B
of words for B2), the key (4 B a row) and each value column (4 B a row
dense, width / 8 B packed) only in the 32-row groups that hold a live row,
and the [G] output grids.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from druid_tpu_torch.data import cascade as cascade_mod
from druid_tpu_torch.engine.contracts import (BLK_SMALL_W, BLK_WIDE_W, LANE,
                                              MAX_PALLAS_FIELDS,
                                              MAX_PALLAS_GROUPS,
                                              MAX_PALLAS_SLOTS, MAX_W,
                                              PACK_WIDTHS, SPAN_BLOCK)

#: launches of the CUDA kernel in this process (the chip smoke resets it)
LAUNCHES = 0
#: calls that `sorted_reduce` routed to the plain version (CPU tensors)
PLAIN_CALLS = 0
#: guards both counts: the broker's scatter threads launch concurrently
COUNT_LOCK = threading.Lock()

SENTINEL = 2**31 - 1
_KINDS = {"count": 0, "sum_i32": 1, "sum_f32": 2, "min_i32": 3,
          "max_i32": 4, "min_f32": 5, "max_f32": 6}
_VALUE_OPS = ("sum_i32", "sum_f32", "min_i32", "max_i32", "min_f32",
              "max_f32")
_MAX_SLOTS = 17                       # SR_MAX_SLOTS in the CUDA source
_MAX_FIELDS = 8                       # SR_MAX_FIELDS in the CUDA source
#: threads per block of the partial pass (SR_THREADS in the CUDA source):
#: each folds BLK / PARTIAL_THREADS consecutive rows
PARTIAL_THREADS = 256


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_window(span: int) -> Tuple[int, int]:
    """(block rows, aligned window W) for a projection span, or (0, 0)."""
    for blk in (BLK_SMALL_W, BLK_WIDE_W):
        eff_span = span * max(blk // SPAN_BLOCK, 1)
        w = _round_up(max(eff_span, 1), LANE) + LANE
        if w <= MAX_W:
            return blk, w
    return 0, 0


def op_fields(ops: Sequence) -> list:
    """Distinct value columns the kernel reads, sorted."""
    return sorted({op[1] for op in ops if op[0] in _VALUE_OPS})


def value_fields(kernels: Sequence, col_dtypes: Dict) -> list:
    """Distinct value columns the kernels' ops read, sorted."""
    return op_fields([k.pallas_op(col_dtypes) for k in kernels])


def op_slots(ops: Sequence) -> int:
    """Output slots in the reference's layout (an int32 sum takes two)."""
    return 1 + sum(2 if op[0] == "sum_i32" else
                   1 if op[0] in _VALUE_OPS else 0 for op in ops)


def usable(kernels: Sequence, col_dtypes: Dict, span: int,
           num_total: int) -> bool:
    """The reference's `pallas_agg.usable` caps, without its backend probe."""
    blk, _ = plan_window(span)
    if num_total > MAX_PALLAS_GROUPS or not blk:
        return False
    ops = [k.pallas_op(col_dtypes) for k in kernels]
    if any(o is None for o in ops):
        return False
    return len(op_fields(ops)) <= MAX_PALLAS_FIELDS \
        and op_slots(ops) <= MAX_PALLAS_SLOTS


def _slot_plan(ops: Sequence) -> List[Tuple[str, object]]:
    """Kernel output slots: the count slot first, then one per value op."""
    return [("count", None)] + [(op[0], op[1]) for op in ops
                                if op[0] in _VALUE_OPS]


def _slot_dtype(kind: str) -> torch.dtype:
    return {"count": torch.int32, "sum_i32": torch.int64,
            "sum_f32": torch.float32, "min_i32": torch.int32,
            "max_i32": torch.int32}.get(kind, torch.float32)


def _identity(kind: str):
    return {"min_i32": 2**31 - 1, "max_i32": -(2**31),
            "min_f32": float("inf"), "max_f32": -float("inf")}.get(kind, 0)


def _plan(arrays: Dict, kernels, num_total, span):
    col_dtypes = cascade_mod.column_dtypes(arrays)
    if not usable(kernels, col_dtypes, span, num_total):
        raise ValueError("plan is outside the sorted-projection kernel's "
                         "caps (usable() is False)")
    blk, w = plan_window(span)
    return [k.pallas_op(col_dtypes) for k in kernels], blk, w


def _states(kernels, ops, slots: List[torch.Tensor], num_total: int):
    """Kernel slot outputs -> (counts, per-kernel states)."""
    counts = slots[0][:num_total]
    it = iter(slots[1:])
    states = []
    for k, op in zip(kernels, ops):
        if op[0] == "count":
            states.append(counts)
        elif op[0] in _VALUE_OPS:
            states.append(next(it)[:num_total])
        else:                                # "zero" / "empty"
            states.append(torch.from_numpy(
                k.empty_state(num_total)).to(counts.device))
    return counts, tuple(states)


def sorted_reduce_plain(arrays: Dict[str, torch.Tensor], mask: torch.Tensor,
                        key: torch.Tensor, kernels: Sequence,
                        num_total: int, span: int):
    """Plain PyTorch version of the kernel: same inputs, same results (float
    sums up to summation order). It reads every value column from the dense
    view `arrays`."""
    ops, blk, w = _plan(arrays, kernels, num_total, span)
    n = key.shape[0]
    g2 = _round_up(num_total, LANE) + w
    nblk = max(1, -(-n // blk))
    keyx = torch.where(mask, key.to(torch.int64),
                       torch.full((), SENTINEL, dtype=torch.int64,
                                  device=key.device))
    kp = torch.full((nblk * blk,), SENTINEL, dtype=torch.int64,
                    device=key.device)
    kp[:n] = keyx
    kb = kp.view(nblk, blk)
    abase = ((kb.min(dim=1).values // LANE) * LANE).clamp(0, g2 - w)
    local = kb - abase[:, None]
    ok = ((local >= 0) & (local < w) & (kb != SENTINEL)).reshape(-1)[:n]
    idx = keyx[ok]
    outs = []
    for kind, field in _slot_plan(ops):
        dt = _slot_dtype(kind)
        out = torch.full((g2,), _identity(kind), dtype=dt, device=key.device)
        if kind == "count":
            out.index_add_(0, idx, torch.ones_like(idx, dtype=dt))
        elif kind in ("sum_i32", "sum_f32"):
            out.index_add_(0, idx, arrays[field][ok].to(dt))
        else:
            out.scatter_reduce_(0, idx, arrays[field][ok],
                                "amin" if kind.startswith("min") else "amax")
        outs.append(out)
    return _states(kernels, ops, outs, num_total)


class _Params(ctypes.Structure):
    """SrParams of csrc/sorted_reduce.cu, field for field."""
    _fields_ = [("keys", ctypes.c_void_p), ("abase", ctypes.c_void_p),
                ("row_off", ctypes.c_void_p), ("row_blocks", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("blk", ctypes.c_int),
                ("W", ctypes.c_int), ("gbase_max", ctypes.c_int),
                ("nblk", ctypes.c_int), ("G", ctypes.c_int),
                ("nslots", ctypes.c_int), ("nfields", ctypes.c_int),
                ("kind", ctypes.c_int * _MAX_SLOTS),
                ("field", ctypes.c_int * _MAX_SLOTS),
                ("fsrc", ctypes.c_void_p * _MAX_FIELDS),
                ("part", ctypes.c_void_p * _MAX_SLOTS),
                ("out", ctypes.c_void_p * _MAX_SLOTS),
                ("mask_words", ctypes.c_void_p),
                ("fwidth", ctypes.c_int * _MAX_FIELDS),
                ("fbase", ctypes.c_int * _MAX_FIELDS)]


def _lib():
    from druid_tpu_torch import _build
    lib = _build.load("sorted_reduce")
    if not getattr(lib, "_sr_typed", False):
        for fn in (lib.sr_partial, lib.sr_partial_words, lib.sr_combine):
            fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._sr_typed = True
    return lib


def packed_fields(fields: Sequence[str], packed_cols: Optional[Dict],
                  blk: int, n: int) -> Dict:
    """{field: PackedColumn} of the value fields the kernel reads as words:
    the reference's rule (pallas_agg.py:227), a block's 128-row tiles a
    whole number of word rows and the words covering the same rows as the
    key. Every other field reads the dense view."""
    out = {}
    for f in fields:
        pc = (packed_cols or {}).get(f)
        if pc is not None and (blk // LANE) % pc.vpw == 0 and pc.rows == n:
            out[f] = pc
    return out


def _check_cuda(arrays: Dict, key, fields, mask_words, words: Dict) -> None:
    if key.device.type != "cuda":
        raise ValueError(f"the sorted-projection kernels need CUDA tensors, "
                         f"got {key.device}")
    n = key.shape[0]
    if key.dim() != 1 or key.dtype != torch.int32 or not key.is_contiguous():
        raise ValueError("key must be a contiguous 1-D int32 tensor")
    for f in fields:
        if f in words:
            pc = words[f]
            w = pc.words
            if pc.width not in PACK_WIDTHS or pc.dtype_str != "int32" \
                    or not torch.is_tensor(w) or w.dim() != 1 \
                    or w.dtype != torch.int32 or w.device != key.device \
                    or not w.is_contiguous() or w.shape[0] < n // pc.vpw:
                raise ValueError(f"packed column {f!r} must be contiguous "
                                 f"int32 words (at least {n // pc.vpw}) on "
                                 f"{key.device}, width in {PACK_WIDTHS}")
            continue
        a = arrays[f]
        if a.shape != (n,) or a.device != key.device \
                or a.dtype not in (torch.int32, torch.float32) \
                or not a.is_contiguous():
            raise ValueError(f"value column {f!r} must be a contiguous "
                             f"int32/float32 [{n}] tensor on {key.device}")
    if mask_words is not None and (
            mask_words.dim() != 1 or mask_words.dtype != torch.int32
            or mask_words.device != key.device
            or not mask_words.is_contiguous()
            or mask_words.shape[0] < -(-n // 32)):
        raise ValueError(f"mask words must be a contiguous int32 tensor of "
                         f"at least {-(-n // 32)} words on {key.device}")


def launch(arrays: Dict[str, torch.Tensor], key: torch.Tensor,
           kernels: Sequence, num_total: int, span: int,
           mask_words: Optional[torch.Tensor] = None,
           packed_cols: Optional[Dict] = None):
    """Both passes on CUDA tensors; raises on anything else. Without
    `mask_words` (B1) masked rows must already carry SENTINEL in `key`;
    with them (B2) `key` is raw and row r counts iff bit r % 32 of word
    r // 32 is set. A value field in `packed_cols` (see `packed_fields`) is
    read as words and never decoded. Counts no launch: each kernel's
    wrapper does."""
    ops, blk, w = _plan(arrays, kernels, num_total, span)
    slots = _slot_plan(ops)
    fields = op_fields(ops)
    dev = key.device
    n = key.shape[0]
    words = packed_fields(fields, packed_cols, blk, n)
    _check_cuda(arrays, key, fields, mask_words, words)
    nblk = max(1, -(-n // blk))
    abase = torch.empty(nblk, dtype=torch.int32, device=dev)
    parts = [torch.empty(nblk * w, dtype=_slot_dtype(k), device=dev)
             for k, _ in slots]
    outs = [torch.empty(num_total, dtype=_slot_dtype(k), device=dev)
            for k, _ in slots]
    p = _Params(keys=key.data_ptr(), abase=abase.data_ptr(), n=n, blk=blk,
                W=w, gbase_max=_round_up(num_total, LANE), nblk=nblk,
                G=num_total, nslots=len(slots), nfields=len(fields),
                mask_words=None if mask_words is None
                else mask_words.data_ptr())
    for f, field in enumerate(fields):
        pc = words.get(field)
        if pc is None:
            p.fsrc[f] = arrays[field].data_ptr()
        else:
            p.fsrc[f] = pc.words.data_ptr()
            p.fwidth[f] = pc.width
            p.fbase[f] = pc.base
    for q, (kind, field) in enumerate(slots):
        p.kind[q] = _KINDS[kind]
        p.field[q] = fields.index(field) if field is not None else -1
        p.part[q] = parts[q].data_ptr()
        p.out[q] = outs[q].data_ptr()
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial = lib.sr_partial if mask_words is None else lib.sr_partial_words
    rc = partial(ctypes.byref(p), stream)
    if rc:
        raise RuntimeError(f"partial pass launch failed: cudaError {rc}")
    # CSR of the blocks covering each 128-group row, in (window base, block)
    # order; fully masked blocks and rows past G go to a row never read
    rg = -(-num_total // LANE)
    wr = w // LANE
    r0 = torch.where(abase >= 0, abase.to(torch.int64) // LANE, rg)
    rows = (r0[:, None] + torch.arange(wr, device=dev)).clamp_(max=rg) \
        .reshape(-1)
    srt, order = torch.sort(rows, stable=True)
    row_blocks = (order // wr).to(torch.int32)
    # row r's entries start where the sorted rows reach r (bincount would
    # read its output size back to the host and stall every launch)
    row_off = torch.searchsorted(srt, torch.arange(rg + 1, device=dev)) \
        .to(torch.int32)
    p.row_off = row_off.data_ptr()
    p.row_blocks = row_blocks.data_ptr()
    rc = lib.sr_combine(ctypes.byref(p), stream)
    if rc:
        raise RuntimeError(f"sr_combine launch failed: cudaError {rc}")
    return _states(kernels, ops, outs, num_total)


def sorted_reduce_cuda(arrays: Dict[str, torch.Tensor], mask: torch.Tensor,
                       key: torch.Tensor, kernels: Sequence, num_total: int,
                       span: int, packed_cols: Optional[Dict] = None):
    """Launch kernel B1 on CUDA tensors; raises on anything else."""
    global LAUNCHES
    if mask.shape != key.shape or mask.dtype != torch.bool \
            or mask.device != key.device:
        raise ValueError("mask must be a bool tensor shaped like key")
    keyx = torch.where(mask, key, torch.full((), SENTINEL, dtype=key.dtype,
                                             device=key.device))
    out = launch(arrays, keyx, kernels, num_total, span,
                 packed_cols=packed_cols)
    with COUNT_LOCK:
        LAUNCHES += 1
    return out


def sorted_reduce(arrays: Dict[str, torch.Tensor], mask: torch.Tensor,
                  key: torch.Tensor, kernels: Sequence, num_total: int,
                  span: int, packed_cols: Optional[Dict] = None):
    """(counts int32 [num_total], per-kernel states): the plain version for
    CPU tensors (on the dense view), the CUDA kernel for CUDA tensors (with
    `packed_cols` as word inputs)."""
    global PLAIN_CALLS
    if key.device.type == "cpu":
        with COUNT_LOCK:
            PLAIN_CALLS += 1
        return sorted_reduce_plain(arrays, mask, key, kernels, num_total,
                                   span)
    return sorted_reduce_cuda(arrays, mask, key, kernels, num_total, span,
                              packed_cols=packed_cols)
