"""HyperLogLog: registers as int32 grids, merged by elementwise max.

The port's counterpart of the reference package's `engine/hll.py`. String
values hash on the host once per dictionary entry (FNV-1a with a splitmix64
finalizer), so the device only gathers (register, rho) or the raw hash by
dictionary id; numeric columns hash on the device with splitmix64. A row's
update is a `scatter_reduce(amax)` of its rho into a [G * m] grid.

The reference hashes in uint64. torch's uint64 lacks shifts and multiplies
on CUDA, so the device side works on int64 bit patterns: a wrapping `*` or
`+` gives the same bits, the constants above 2^63 are written as their
signed equivalents, and every right shift masks off the sign-extended bits
(a logical shift). The estimator runs on the host over numpy.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

DEFAULT_LOG2M = 11


def _signed(c: int) -> int:
    """The int64 whose bits are the uint64 `c`."""
    return c - (1 << 64) if c >= 1 << 63 else c


_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


# ---------------------------------------------------------------------------
# Hashing (host)
# ---------------------------------------------------------------------------

def _splitmix64_np(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over numpy uint64."""
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(_GOLDEN)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(_MIX1)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(_MIX2)
        x = x ^ (x >> np.uint64(31))
    return x


def hash_strings(values) -> np.ndarray:
    """uint64 hashes of strings: FNV-1a over the UTF-8 bytes, then
    splitmix64."""
    out = np.empty(len(values), dtype=np.uint64)
    offset, prime, mask = 0xCBF29CE484222325, 0x100000001B3, (1 << 64) - 1
    for i, v in enumerate(values):
        h = offset
        for b in v.encode("utf-8"):
            h = ((h ^ b) * prime) & mask
        out[i] = h
    return _splitmix64_np(out)


def hash_to_register(hashes: np.ndarray,
                     log2m: int) -> Tuple[np.ndarray, np.ndarray]:
    """hash -> (register index int32, rho int32): rho is 1 + the leading
    zeros of the remaining 64 - log2m bits, 65 - log2m when they are 0."""
    hashes = np.asarray(hashes, dtype=np.uint64)
    m = 1 << log2m
    reg = (hashes & np.uint64(m - 1)).astype(np.int32)
    rest = hashes >> np.uint64(log2m)
    width = 64 - log2m
    hb = np.zeros(rest.shape, dtype=np.int32)
    x = rest.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        big = x >= (np.uint64(1) << np.uint64(shift))
        hb = np.where(big, hb + shift, hb)
        x = np.where(big, x >> np.uint64(shift), x)
    rho = np.where(rest != 0, width - hb, width + 1).astype(np.int32)
    return reg, rho


def dim_register_tables(dictionary,
                        log2m: int = DEFAULT_LOG2M
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-dictionary-id (register, rho) tables for a device gather."""
    return hash_to_register(hash_strings(dictionary.values), log2m)


def dim_hash_table(dictionary) -> np.ndarray:
    """Per-dictionary-id raw uint64 hashes (the byRow combined hash)."""
    return hash_strings(dictionary.values)


# ---------------------------------------------------------------------------
# Device side: int64 bit patterns
# ---------------------------------------------------------------------------

def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 over int64 tensors holding uint64 bits."""
    x = x.to(torch.int64) + _signed(_GOLDEN)
    x = (x ^ _shr(x, 30)) * _signed(_MIX1)
    x = (x ^ _shr(x, 27)) * _signed(_MIX2)
    return x ^ _shr(x, 31)


def hash_numeric(v: torch.Tensor) -> torch.Tensor:
    """A numeric column's hashes, as the reference's: a float hashes the
    bits of its float64 value (so -0.0 and 0.0 differ), an integer its
    int64 value."""
    if v.dtype.is_floating_point:
        return splitmix64(v.to(torch.float64).view(torch.int64))
    return splitmix64(v.to(torch.int64))


def register_of(hashes: torch.Tensor,
                log2m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device counterpart of hash_to_register over int64 hash bits."""
    reg = (hashes & ((1 << log2m) - 1)).to(torch.int32)
    rest = _shr(hashes, log2m)          # sign bit clear: compares are safe
    width = 64 - log2m
    hb = torch.zeros(rest.shape, dtype=torch.int32, device=rest.device)
    x = rest
    for shift in (32, 16, 8, 4, 2, 1):
        big = x >= (1 << shift)
        hb = torch.where(big, hb + shift, hb)
        x = torch.where(big, x >> shift, x)
    rho = torch.where(rest != 0, width - hb, width + 1).to(torch.int32)
    return reg, rho


def update_registers(registers, rho: torch.Tensor, reg: torch.Tensor,
                     keys: torch.Tensor, mask: torch.Tensor, num: int,
                     log2m: int) -> torch.Tensor:
    """Scatter-max of each masked row's rho into its (group, register) cell
    of a [num, m] int32 grid from zeros, maxed into `registers` when given.
    `keys` are in [0, num)."""
    m = 1 << log2m
    cell = keys.to(torch.int64) * m + reg.to(torch.int64)
    val = torch.where(mask, rho, 0).to(torch.int32)
    upd = torch.zeros(num * m, dtype=torch.int32, device=rho.device) \
        .scatter_reduce_(0, cell, val, "amax").view(num, m)
    return upd if registers is None else torch.maximum(registers, upd)


# ---------------------------------------------------------------------------
# Estimation (host)
# ---------------------------------------------------------------------------

def estimate(registers: np.ndarray, log2m: int = DEFAULT_LOG2M) -> float:
    """The HLL estimate of one register array, with the small- and
    large-range corrections (HyperLogLogCollector.estimateCardinality)."""
    regs = np.asarray(registers).reshape(-1)
    m = 1 << log2m
    if regs.shape[0] != m:
        raise ValueError(f"expected {m} registers, got {regs.shape}")
    alpha = 0.7213 / (1 + 1.079 / m)
    raw = alpha * m * m / np.power(2.0, -regs.astype(np.float64)).sum()
    if raw <= 2.5 * m:
        zeros = int((regs == 0).sum())
        if zeros:
            return m * np.log(m / zeros)
    two64 = 2.0 ** 64
    if raw > two64 / 30.0:
        return -two64 * np.log(1.0 - raw / two64)
    return float(raw)


def estimate_array(registers: np.ndarray,
                   log2m: int = DEFAULT_LOG2M) -> np.ndarray:
    """float64 [G] estimates of a [G, m] register grid."""
    regs = np.asarray(registers)
    if regs.ndim == 1:
        regs = regs[None, :]
    m = 1 << log2m
    if regs.shape[-1] != m:
        raise ValueError(f"expected {m} registers, got {regs.shape}")
    alpha = 0.7213 / (1 + 1.079 / m)
    raw = alpha * m * m / np.power(2.0, -regs.astype(np.float64)).sum(axis=-1)
    zeros = (regs == 0).sum(axis=-1)
    small = raw <= 2.5 * m
    with np.errstate(divide="ignore"):
        lin = np.where(zeros > 0, m * np.log(m / np.maximum(zeros, 1)), raw)
    out = np.where(small & (zeros > 0), lin, raw)
    two64 = 2.0 ** 64
    big = out > two64 / 30.0
    return np.where(big, -two64 * np.log1p(-out / two64), out)
