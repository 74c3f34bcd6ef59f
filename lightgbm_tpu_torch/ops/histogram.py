"""Histogram construction (PyTorch port of `lightgbm_tpu/ops/histogram.py`).

The engines' histograms come from entry points with the JAX package's
signatures and output contracts:

* `build_histogram_wave` — all leaf slots of a wave in one pass: K1 (the
  TPU kernel it replaces is `_wave_kernel` in fp32 mode), or K2 when
  `quant_scales` is given (`_wave_kernel` in int8 mode);
* `build_histogram_wave_hl` — the first `num_slots` computed slots only,
  zero-padded to `out_slots` (K3; replaces `_wave_kernel_hl`);
* `build_histogram_rows_pallas` — one leaf's histogram over row-major
  rows with a membership mask (K4; replaces `_hist_pallas_kernel`).

On a CUDA tensor each entry point launches its hand-written kernel
(`ops/csrc/wave_hist.cu`, `ops/csrc/rows_hist.cu`, built and bound by
`ops/_kernels.py`) or raises; on a CPU tensor it runs its plain PyTorch
version.  Each keeps a launch count (`<entry point>.launches`; K2's is
`build_histogram_wave_int.launches`) that only kernel launches advance.

Arithmetic (the kernels and the plain versions alike).  K1, K3 and K4
sum every histogram value as 64-bit fixed point, channel c scaled by
2^(62 - E_c) with 2^E_c >= max|gh[:, c]| * n, then convert to float32.
Integer sums do not depend on the order of addition, so the kernels are
deterministic from run to run and agree bit for bit with the plain
versions.  K2 recovers the quantized integers k = round(gh / scale) and
sums them exactly; its output is float32(sum k) * scale.

The engines use the `*_fixed` and `wave_hist_int` variants, which return
the integer sums: with one exponent set per tree (`scale_exps` of the
tree's whole gh) every histogram of a tree lies on one grid, so the
larger sibling's histogram, parent - smaller child, is exact, and a bin
that holds no row of a leaf is exactly 0 (`find_best_split`'s
`snap_over_empty` relies on that).  `from_fixed` (with the grid's
`fixed_unit`) and `dequantize` convert where the scan reads them.

`build_histogram` (the segment method, `index_add_` in float32) is the
plain single-leaf oracle the tests hold the other histograms against.

Launch plans.  The kernels take their shapes from the planners here
(`wave_part_plan`, `wave_few_plan`, `rows_plan`), which the CPU tests
check.  K1, and K2 at many slots, partition the computed rows by slot on
the card and walk work items of (slot, feature group, at most R rows).
K3, and K2 at few slots (`K2_FEW_SLOTS`), stream every row through tiles
that hold every computed slot of a feature group.  The wave kernels read
the feature-major bins only; `build_histogram_wave_hl` keeps the JAX
signature's row-major `binned_rm` (its plain version reads it), and only
K4 reads a row-major copy.

Bin codes.  The device holds `uint8` codes while every column has at most
256 bins, 16-bit codes up to `MAX_CODE_BINS` bins, and `int32` codes
above that (the JAX package keeps int32 codes above 256 bins).  Torch's
`uint16` has few CPU ops, so 16-bit codes are stored as `int16` holding
the code's bits: the kernels read them as `uint16_t` (each is templated
on the code type; `int32` codes, always below 2^31, as `uint32_t`) and
the plain versions as `codes_to_int`, which masks the sign extension
away.  Where one feature's bins do not fit a block's shared memory the
planners cut the bin axis into windows (`bin_window`): a block covers one
window of one feature group and skips codes outside it, the redesign of
the JAX kernel's `Bg` grid axis.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _kernels

# Shared memory one block may hold on an H100 (227 KB), and one SM's
# (228 KB, of which each resident block reserves 1 KB): the tile rules
# below budget against them.
SMEM_LIMIT = 232448
SM_SMEM = 233472
BLOCK_RESERVED_SMEM = 1024
FEW_THREADS = 512    # threads of a streaming block (kFewThreads)
ROW_TILE = 512


# --------------------------------------------------------------- bin codes
MAX_CODE_BINS = 1 << 16    # bins a 16-bit code holds
CODE_DTYPES = (torch.uint8, torch.int16, torch.int32)


def code_dtype(num_bin: int) -> torch.dtype:
    """The device code type for columns of at most `num_bin` bins: uint8
    up to 256, int16 storage of uint16 codes up to MAX_CODE_BINS, else
    int32."""
    if num_bin <= 256:
        return torch.uint8
    if num_bin <= MAX_CODE_BINS:
        return torch.int16
    return torch.int32


def codes_to_device(codes, device, num_bin: int = None) -> torch.Tensor:
    """Host bin codes (any integer numpy array) -> the device code type
    of `num_bin` bins (default: the codes' largest + 1)."""
    codes = np.asarray(codes)
    if num_bin is None:
        num_bin = int(codes.max(initial=0)) + 1
    dt = code_dtype(num_bin)
    if dt == torch.uint8:
        host = np.ascontiguousarray(codes, np.uint8)
    elif dt == torch.int16:
        host = np.ascontiguousarray(codes.astype(np.uint16).view(np.int16))
    else:
        host = np.ascontiguousarray(codes, np.int32)
    return torch.from_numpy(host).to(device)


def codes_to_int(codes: torch.Tensor,
                 dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """Device bin codes as integers: uint8 and int32 as they are, int16
    storage as its uint16 value (the sign extension masked off)."""
    out = codes.to(dtype)
    return out & 0xFFFF if codes.dtype == torch.int16 else out


def hl_split_of(max_bin: int, num_slots: int, C: int):
    """(Bh, Bl) split of the JAX decomposed kernel; kept because the
    dispatch rule `wave_hl_profitable` is defined through it."""
    CS = C * num_slots
    best = None
    for Bl in (2, 4, 8, 16, 32):
        Bh = -(-max_bin // Bl)
        Bh8 = max(8, -(-Bh // 8) * 8)
        cost = Bh8 + Bl * CS
        if best is None or cost < best[0]:
            best = (cost, Bh8, Bl)
    return best[1], best[2]


def wave_hl_profitable(max_bin: int, num_slots: int, C: int = 2) -> bool:
    """The JAX dispatch rule: the waves it marks go to the few-slot kernel
    (K3).  At max_bin=255 that is num_slots in {1, 2, 4, 8}."""
    Bh, Bl = hl_split_of(max_bin, num_slots, C)
    return Bh <= 256 and (Bh + Bl * C * num_slots) <= 0.6 * max_bin


def wave_hl_fits(max_bin: int, num_slots: int, C: int = 2) -> bool:
    """The wave engine's rule for K3 (replaces the TPU VMEM rule
    `_hl_fits` of learner/wave.py): every computed slot's histograms of
    one whole feature, plus the slot counts, fit the streaming kernel's
    tile budget in one bin window (`wave_few_plan`).  At max_bin <= 256
    it holds for every wave that `wave_hl_profitable` marks (at most 11
    slots); at 1023 bins for up to 7 slots, so the profitable waves of
    8 slots and more take K1 (a plan: K1's launch count shows them)."""
    return num_slots * (max_bin * C * 8 + 8) <= FEW_TILE_BYTES


def wave_slot_pad(num_slots: int) -> int:
    """Slot-axis padding of the wave engine's static slot bounds."""
    if num_slots <= 128:
        return max(8, (num_slots + 7) // 8 * 8)
    return (num_slots + 127) // 128 * 128


# K1, K2 and K4 tiles: (features x B x C) cells plus one count cell in
# at most this many bytes, so several blocks share an SM.
TILE_BYTES = 32 * 1024
TILE_FEATURES = 8    # most features of one 8-byte-cell tile (kMaxFG)
UNIT_ROWS = 512      # rows of one warp's chunk in the partition passes
PART_WARPS = 8       # warps of one partition block, where they fit
K4_MIN_ROWS = 512    # K4: rows of one block at least
K4_BLOCKS = 2048     # K4: blocks aimed at for large segments
# The streaming kernel (K3; K2 at few slots): every computed slot of a
# feature group in a tile of at most FEW_TILE_BYTES, half an SM, so two
# 512-thread blocks share an SM (on the card, fewer feature groups and
# more warps per tile beat more, smaller tiles: PERF.md).  K2 takes it up
# to K2_FEW_SLOTS slots and the partition above that.
FEW_TILE_BYTES = SM_SMEM // 2 - BLOCK_RESERVED_SMEM
K2_FEW_SLOTS = 8


def bin_window(max_bin: int, C: int, cell_bytes: int = 8,
               budget: int = SMEM_LIMIT, slots: int = 1) -> int:
    """Bins of one window of a K1/K2/K4 tile (`slots` = 1) or of a
    streaming tile of `slots` slots: max_bin when one feature's
    (slots x B x C) cells and the count cells fit `budget`, else the
    fewest equal windows whose cells fit (a block covers one window and
    skips the codes outside it)."""
    room = budget - cell_bytes * slots
    per_bin = slots * C * cell_bytes
    if room < per_bin:
        raise ValueError(f"{slots} slots with {C} channels exceed the "
                         "kernel's shared memory even one bin at a time")
    if max_bin * per_bin <= room:
        return max_bin
    windows = -(-max_bin // (room // per_bin))
    return -(-max_bin // windows)


def tile_feature_group(num_features: int, max_bin: int, C: int,
                       cell_bytes: int = 8) -> int:
    """Features per K1/K2 work item and per K4 block: the fewest equal
    groups of at most TILE_FEATURES (twice as many with K2's 4-byte
    cells) whose (FG x B x C) tile and count cell fit TILE_BYTES (one
    feature per group, up to SMEM_LIMIT, where not even one fits; above
    that one feature's bins are cut into windows, `bin_window`)."""
    per = max_bin * C * cell_bytes
    fg_max = min(TILE_FEATURES * 8 // cell_bytes,
                 (TILE_BYTES - cell_bytes) // per)
    if fg_max < 1:
        return 1
    groups = -(-num_features // fg_max)
    return -(-num_features // groups)


class WavePlan(NamedTuple):
    """The partition's launch plan (K1; K2 at many slots): PW warps per
    partition block (each keeps NL int32 counters in shared memory); FG
    features and at most R rows per work item; U warp units of UR rows
    in the partition; rows packed at Fp codes and their values at QS
    cells per row; bytes of scratch, of a histogram tile and of a
    partition block's counters; Bw bins per window (max_bin but for
    the widest features)."""
    PW: int
    FG: int
    R: int
    UR: int
    U: int
    Fp: int
    QS: int
    scratch_bytes: int
    tile_bytes: int
    part_smem: int
    Bw: int


def wave_part_plan(n: int, num_features: int, max_bin: int, C: int,
                   num_slots: int, cell_bytes: int = 8,
                   code_bytes: int = 1) -> WavePlan:
    """The partition's plan, for K1's 8-byte fixed-point cells or K2's
    4-byte ints, on codes of `code_bytes` bytes (`wave_hist.cu`
    run_partition and part_scratch use the same layout)."""
    FG = tile_feature_group(num_features, max_bin, C, cell_bytes)
    Bw = bin_window(max_bin, C, cell_bytes)
    R = min(4096, max(256, n // 1024))
    U = -(-n // UNIT_ROWS)
    Fp = -(-num_features // 16) * 16
    QS = -(-(C + 1) * cell_bytes // 16) * 16 // cell_bytes
    ints = num_slots * U + num_slots + 2 * (num_slots + 1)
    scratch = (-(-ints * 4 // 256) * 256
               + -(-n * Fp * code_bytes // 256) * 256
               + n * QS * cell_bytes)
    PW = min(PART_WARPS, SMEM_LIMIT // (4 * num_slots))
    if PW < 1:
        raise ValueError(f"{num_slots} slots exceed the partition's shared "
                         "memory")
    return WavePlan(PW, FG, R, UNIT_ROWS, U, Fp, QS, scratch,
                    cell_bytes * (FG * Bw * C + 1), 4 * PW * num_slots, Bw)


class FewPlan(NamedTuple):
    """The streaming kernel's plan (K3; K2 at few slots): FG features
    per block, its tile's bytes, the blocks one SM holds by shared
    memory and threads, and Bw bins per window (max_bin unless one
    feature's bins of every slot exceed the budget)."""
    FG: int
    tile_bytes: int
    blocks_per_sm: int
    Bw: int


def wave_few_plan(num_features: int, max_bin: int, C: int, num_slots: int,
                  cell_bytes: int = 8,
                  tile_budget: int = FEW_TILE_BYTES) -> FewPlan:
    """Feature groups of the streaming kernel: the fewest equal groups
    whose tile (num_slots x FG x B x C cells plus num_slots counts) fits
    `tile_budget`, one feature cut into bin windows where not even one
    fits (`wave_hist.cu` launch_few sizes it the same way)."""
    Bw = bin_window(max_bin, C, cell_bytes, tile_budget, num_slots)
    per = num_slots * Bw * C * cell_bytes
    fg_max = max(1, min(num_features,
                        (tile_budget - cell_bytes * num_slots) // per))
    FG = -(-num_features // -(-num_features // fg_max))
    tile = cell_bytes * num_slots * (FG * Bw * C + 1)
    blocks = min(SM_SMEM // (tile + BLOCK_RESERVED_SMEM),
                 2048 // FEW_THREADS)
    return FewPlan(FG, tile, blocks, Bw)


def rows_plan(S: int, num_features: int, max_bin: int, C: int):
    """K4's launch plan (FG, rows_per_block): feature groups from the
    tile budget, and row chunks of at least K4_MIN_ROWS rows (a multiple
    of 512) sized so that about K4_BLOCKS blocks cover a large segment.
    Its bin windows are `bin_window(max_bin, C)`."""
    FG = tile_feature_group(num_features, max_bin, C)
    groups = (-(-num_features // FG)
              * -(-max_bin // bin_window(max_bin, C)))
    per = -(-S // max(1, K4_BLOCKS // groups))
    R = max(K4_MIN_ROWS, -(-per // 512) * 512)
    return FG, R


# --------------------------------------------------------------- fixed point
def scale_exps(gh: torch.Tensor, num_rows: int = None,
               net=None) -> torch.Tensor:
    """[k] int32 exponents E with max|gh[:, c]| * n <= 2^E for gh [n, k]
    (frexp of the float32 product, clamped to [-38, 62]): the grid of
    every fixed-point histogram of these rows or of any subset of them.
    A data-parallel rank passes `num_rows`, the row count the serial run
    pads to, and its `net` (parallel/data_parallel.py Network), which
    all-reduces the maximum: every rank then takes the serial run's
    grid, and the ranks' int64 sums add up to the serial run's."""
    n = gh.shape[0]
    amax = (torch.linalg.vector_norm(gh, float("inf"), dim=0) if n
            else gh.new_zeros(gh.shape[1]))
    if net is not None:
        net.all_reduce_max_(amax)
    if num_rows is not None:
        n = num_rows
    _, e = torch.frexp(amax * float(n))
    return e.clamp(-38, 62).to(torch.int32)


def _pow2_f32(k: torch.Tensor) -> torch.Tensor:
    """Exact float32 2^k for integer k in [-126, 127], from the bits."""
    return ((k.to(torch.int32) + 127) << 23).view(torch.float32)


def fixed_unit(e: torch.Tensor) -> torch.Tensor:
    """The float64 value 2^(e - 62) of one fixed-point step on the grid
    `e` (exact, from the bits)."""
    return ((e.to(torch.int64) + (1023 - 62)) << 52).view(torch.float64)


def _to_fixed(v: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """float32 [n, k] -> int64 [n, k]: round-half-even(v * 2^(62 - e))."""
    return torch.round(v * _pow2_f32(62 - e)[None, :]).to(torch.int64)


def wave_slot_counts(slot: torch.Tensor, count: torch.Tensor,
                     exps: torch.Tensor, num_slots: int) -> torch.Tensor:
    """The count channel of the wave kernels' outputs alone: int64 [NL]
    sums of the count column `count` [n] per slot, on the fixed-point
    grid exponent `exps` (0-d int32), or of `count > 0` with `exps` None
    (K2's quantized count).  A feature-parallel rank whose column block
    is empty has no histogram to build but needs its leaves' counts."""
    q = ((count > 0).to(torch.int64) if exps is None
         else _to_fixed(count[:, None], exps.reshape(1))[:, 0])
    s = slot.to(torch.int64)
    ids = torch.where((s >= 0) & (s < num_slots), s, num_slots)
    out = torch.zeros(num_slots + 1, dtype=torch.int64, device=count.device)
    return out.index_add_(0, ids, q)[:num_slots]


def from_fixed(acc: torch.Tensor, unit: torch.Tensor) -> torch.Tensor:
    """int64 sums -> float32 via float64 (the kernels' finish pass); the
    last axis of `acc` is the channel axis of `unit` (`fixed_unit`)."""
    return (acc * unit).to(torch.float32)     # int64 * float64 -> float64


def dequantize(acc: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Quantized integer sums -> float32(sum) * scale (K2's finish pass);
    the last axis of `acc` is the channel axis of `scales`."""
    return acc.to(torch.float32) * scales


def _quant_ints(gh: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """[n, C+1] int64: round(gh[:, :C] / scales) (half to even, as
    `jnp.round`) and the count column gh[:, C] > 0."""
    C = gh.shape[1] - 1
    k = torch.round(gh[:, :C] / scales[None, :]).to(torch.int64)
    return torch.cat([k, (gh[:, C:] > 0).to(torch.int64)], dim=1)


def _check_codes(name: str, codes: torch.Tensor) -> None:
    if codes.dtype not in CODE_DTYPES:
        raise TypeError(f"{name} must be uint8, int16 (16-bit) or int32 "
                        f"codes, got {codes.dtype}")


def _check_wave_inputs(binned: torch.Tensor, slot: torch.Tensor,
                       gh: torch.Tensor, max_bin: int):
    _check_codes("binned", binned)
    if slot.dtype != torch.int32:
        raise TypeError(f"slot must be int32, got {slot.dtype}")
    if gh.dtype != torch.float32:
        raise TypeError(f"gh must be float32, got {gh.dtype}")
    if gh.dim() != 2 or gh.shape[1] < 2:
        raise ValueError(f"gh must be [n, C+1], got {tuple(gh.shape)}")
    n = gh.shape[0]
    shape_ok = (binned.dim() == 2
                and binned.shape[1] == n
                and slot.shape == (n,))
    if not shape_ok:
        raise ValueError(f"inconsistent shapes: binned {tuple(binned.shape)}, "
                         f"slot {tuple(slot.shape)}, gh {tuple(gh.shape)}")
    if n % ROW_TILE != 0:
        raise ValueError(f"n {n} not a multiple of row_tile {ROW_TILE}")
    if not (binned.device == slot.device == gh.device):
        raise ValueError("binned, slot and gh must share a device")
    for name, t in (("binned", binned), ("slot", slot), ("gh", gh)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if gh.shape[1] - 1 > 4:
        raise ValueError("at most 4 accumulated gh channels")
    if not 1 <= max_bin < 1 << 31:
        raise ValueError(f"max_bin must be in [1, 2^31), got {max_bin}")


def _check_exps(exps: torch.Tensor, k: int, device) -> None:
    if exps.dtype != torch.int32 or exps.shape != (k,):
        raise ValueError(f"exps must be int32 [{k}], got {exps.dtype} "
                         f"{tuple(exps.shape)}")
    if exps.device != device:
        raise ValueError("exps must lie on the data's device")


def _check_scales(scales: torch.Tensor, gh: torch.Tensor) -> torch.Tensor:
    C = gh.shape[1] - 1
    if (scales.dtype != torch.float32 or scales.shape != (C,)
            or scales.device != gh.device):
        raise ValueError(f"quant_scales must be float32 [{C}] on the data's "
                         "device")
    return scales.contiguous()


def _check_cuda(dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")


def _check_aligned(binned_fm, slot, gh) -> None:
    """The wave kernels load 4 rows of one feature's bins as one word (4
    bytes of uint8 codes, 8 of 16-bit ones, 16 of int32 ones), and 4
    rows' slots and gh as 16-byte vectors."""
    word = 4 * binned_fm.element_size()
    if (binned_fm.data_ptr() % word or slot.data_ptr() % 16
            or gh.data_ptr() % 16):
        raise ValueError(f"the wave kernels need binned_fm {word}-byte "
                         "aligned and slot and gh 16-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


# ------------------------------------------------------------ plain versions
def _wave_sums_plain(binned_fm: torch.Tensor, slot: torch.Tensor,
                     q: torch.Tensor, max_bin: int, num_slots: int):
    """int64 sums of q [n, C+1] (the last column the count) over flat
    (slot, bin) ids, one feature at a time: (acc [NL, F, B, C],
    cnt [NL])."""
    F, n = binned_fm.shape
    C = q.shape[1] - 1
    B, NL = max_bin, num_slots
    s = slot.to(torch.int64)
    in_slot = (s >= 0) & (s < NL)
    dump = NL * B                                         # sentinel segment
    hist = torch.zeros((F, NL * B + 1, C), dtype=torch.int64,
                       device=q.device)
    for f in range(F):
        b = codes_to_int(binned_fm[f])
        ids = torch.where(in_slot & (b < B), s * B + b, dump)
        hist[f].index_add_(0, ids, q[:, :C])
    acc = hist[:, :NL * B].reshape(F, NL, B, C).permute(1, 0, 2, 3)
    cnt = torch.zeros(NL + 1, dtype=torch.int64, device=q.device)
    cnt.index_add_(0, torch.where(in_slot, s, NL), q[:, C])
    return acc.contiguous(), cnt[:NL]


def build_histogram_wave_plain(binned_fm: torch.Tensor, slot: torch.Tensor,
                               gh: torch.Tensor, *, max_bin: int,
                               num_slots: int, exps: torch.Tensor = None,
                               fixed: bool = False):
    """Plain PyTorch K1: int64 `index_add_` of the fixed-point gh over
    flat (slot, bin) ids.  Returns (hist [NL, F, B, C] float32,
    counts [NL] float32), or the int64 sums when `fixed`.  `exps`
    defaults to `scale_exps(gh)`."""
    e = scale_exps(gh) if exps is None else exps
    acc, cnt = _wave_sums_plain(binned_fm, slot, _to_fixed(gh, e), max_bin,
                                num_slots)
    if fixed:
        return acc, cnt
    C = gh.shape[1] - 1
    u = fixed_unit(e)
    return from_fixed(acc, u[:C]), from_fixed(cnt[:, None], u[C:])[:, 0]


def build_histogram_wave_int_plain(binned_fm: torch.Tensor,
                                   slot: torch.Tensor, gh: torch.Tensor,
                                   quant_scales: torch.Tensor, *,
                                   max_bin: int, num_slots: int,
                                   fixed: bool = False):
    """Plain PyTorch K2: the quantized integers round(gh[:, :C] / scales)
    and the count column gh[:, C] > 0, summed with int64 `index_add_`.
    Returns (float32(sums) * scales, float32 counts), or the int64 sums
    when `fixed`."""
    acc, cnt = _wave_sums_plain(binned_fm, slot,
                                _quant_ints(gh, quant_scales), max_bin,
                                num_slots)
    if fixed:
        return acc, cnt
    return dequantize(acc, quant_scales), cnt.to(torch.float32)


def build_histogram_wave_hl_plain(binned_fm: torch.Tensor,
                                  binned_rm: torch.Tensor,
                                  slot: torch.Tensor, gh: torch.Tensor, *,
                                  max_bin: int, num_slots: int,
                                  out_slots: int, exps: torch.Tensor = None,
                                  fixed: bool = False):
    """Plain PyTorch K3: K1's plain result for the first `num_slots`
    slots (from the row-major bins, as the kernel reads them),
    zero-padded to `out_slots`."""
    hist, cnt = build_histogram_wave_plain(
        binned_rm.t(), slot, gh, max_bin=max_bin, num_slots=num_slots,
        exps=exps, fixed=fixed)
    pad = out_slots - num_slots
    if pad > 0:
        hist = torch.cat([hist, hist.new_zeros((pad,) + hist.shape[1:])])
        cnt = torch.cat([cnt, cnt.new_zeros(pad)])
    return hist, cnt


def build_histogram_rows_plain(rows: torch.Tensor, gh: torch.Tensor,
                               mask: torch.Tensor, *, max_bin: int,
                               exps: torch.Tensor = None,
                               fixed: bool = False) -> torch.Tensor:
    """Plain PyTorch K4: the fixed-point gh * mask summed with int64
    `index_add_` over flat (feature, bin) ids of rows [S, F].  Returns
    hist [F, B, C] float32, or the int64 sums when `fixed`.  `exps`
    defaults to `scale_exps(gh * mask)`."""
    S, F = rows.shape
    C = gh.shape[1]
    B = max_bin
    v = gh * mask.to(gh.dtype)[:, None]
    e = scale_exps(v) if exps is None else exps
    q = _to_fixed(v, e)
    acc = torch.zeros((F * B + 1, C), dtype=torch.int64, device=gh.device)
    dump = F * B
    for f in range(F):
        b = codes_to_int(rows[:, f])
        acc.index_add_(0, torch.where(b < B, f * B + b, dump), q)
    acc = acc[:F * B].reshape(F, B, C)
    return acc if fixed else from_fixed(acc, fixed_unit(e))


# ------------------------------------------------------------ kernel launches
def _launch(dev, fn, *args):
    """Call the C entry point `fn(*args, stream)` on `dev`'s current
    stream; the kernels launch on the thread's current device, switched
    to `dev` only where it differs."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


def _launch_wave(binned_fm, slot, gh, exps, max_bin, num_slots, finish):
    """K1 on the card: float32 (hist, counts) when `finish`, else the
    int64 sums."""
    _check_aligned(binned_fm, slot, gh)
    F, n = binned_fm.shape
    C = gh.shape[1] - 1
    cb = binned_fm.element_size()
    plan = wave_part_plan(n, F, max_bin, C, num_slots, code_bytes=cb)
    dev = gh.device
    acc = torch.empty((num_slots, F, max_bin, C), dtype=torch.int64,
                      device=dev)
    cnt_acc = torch.empty(num_slots, dtype=torch.int64, device=dev)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=dev)
    hist, counts = _finish_outputs(finish, num_slots, F, max_bin, C, dev)
    err = _launch(
        dev, _kernels.lib().wave_hist_f32, binned_fm.data_ptr(),
        slot.data_ptr(), gh.data_ptr(), exps.data_ptr(), n, F, max_bin, C,
        num_slots, cb, plan.Bw, plan.UR, plan.PW, plan.FG, plan.R,
        scratch.data_ptr(),
        plan.scratch_bytes, acc.data_ptr(), cnt_acc.data_ptr(), _ptr(hist),
        _ptr(counts))
    _kernels.check(err, "wave_hist_f32")
    build_histogram_wave.launches += 1
    return (hist, counts) if finish else (acc, cnt_acc)


def _finish_outputs(finish, slots, F, max_bin, C, dev):
    """float32 (hist, counts) for a finish pass, else (None, None)."""
    if not finish:
        return None, None
    return (torch.empty((slots, F, max_bin, C), dtype=torch.float32,
                        device=dev),
            torch.empty(slots, dtype=torch.float32, device=dev))


def _launch_wave_int(binned_fm, slot, gh, scales, max_bin, num_slots,
                     finish, few=None, tile_budget=FEW_TILE_BYTES):
    """K2 on the card: float32 (hist, counts) when `finish`, else the
    int64 sums.  `few` picks the route (default: the streaming kernel up
    to K2_FEW_SLOTS slots, else the partition); `tile_budget` sizes the
    streaming kernel's tile."""
    _check_aligned(binned_fm, slot, gh)
    F, n = binned_fm.shape
    C = gh.shape[1] - 1
    if few is None:
        few = num_slots <= K2_FEW_SLOTS
    dev = gh.device
    cb = binned_fm.element_size()
    if few:
        FG, _, _, Bw = wave_few_plan(F, max_bin, C, num_slots, 4,
                                     tile_budget)
        UR = PW = R = nbytes = 0
        scratch = None
    else:
        plan = wave_part_plan(n, F, max_bin, C, num_slots, cell_bytes=4,
                              code_bytes=cb)
        FG, UR, PW, R, Bw = plan.FG, plan.UR, plan.PW, plan.R, plan.Bw
        nbytes = plan.scratch_bytes
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    acc = torch.empty((num_slots, F, max_bin, C), dtype=torch.int64,
                      device=dev)
    cnt_acc = torch.empty(num_slots, dtype=torch.int64, device=dev)
    hist, counts = _finish_outputs(finish, num_slots, F, max_bin, C, dev)
    err = _launch(
        dev, _kernels.lib().wave_hist_i32, binned_fm.data_ptr(),
        slot.data_ptr(), gh.data_ptr(), scales.data_ptr(), n, F, max_bin, C,
        num_slots, cb, Bw, int(few), UR, PW, FG, R, _ptr(scratch), nbytes,
        acc.data_ptr(), cnt_acc.data_ptr(), _ptr(hist), _ptr(counts))
    _kernels.check(err, "wave_hist_i32")
    build_histogram_wave_int.launches += 1
    return (hist, counts) if finish else (acc, cnt_acc)


def _launch_wave_hl(binned_fm, slot, gh, exps, max_bin, num_slots,
                    out_slots, finish, tile_budget=FEW_TILE_BYTES):
    """K3 on the card: float32 when `finish`, else the int64 sums;
    `tile_budget` sizes the streaming kernel's tile."""
    _check_aligned(binned_fm, slot, gh)
    F, n = binned_fm.shape
    C = gh.shape[1] - 1
    FG, _, _, Bw = wave_few_plan(F, max_bin, C, num_slots, 8, tile_budget)
    dev = gh.device
    acc = torch.empty((out_slots, F, max_bin, C), dtype=torch.int64,
                      device=dev)
    cnt_acc = torch.empty(out_slots, dtype=torch.int64, device=dev)
    hist, counts = _finish_outputs(finish, out_slots, F, max_bin, C, dev)
    err = _launch(
        dev, _kernels.lib().wave_hist_hl_f32, binned_fm.data_ptr(),
        slot.data_ptr(), gh.data_ptr(), exps.data_ptr(), n, F, max_bin, C,
        num_slots, binned_fm.element_size(), Bw, out_slots, FG,
        acc.data_ptr(), cnt_acc.data_ptr(),
        _ptr(hist), _ptr(counts))
    _kernels.check(err, "wave_hist_hl_f32")
    build_histogram_wave_hl.launches += 1
    return (hist, counts) if finish else (acc, cnt_acc)


def _launch_rows(rows, gh, mask, exps, max_bin, finish):
    """K4 on the card: float32 [F, B, C] when `finish`, else int64."""
    S, F = rows.shape
    C = gh.shape[1]
    FG, R = rows_plan(S, F, max_bin, C)
    Bw = bin_window(max_bin, C)
    dev = gh.device
    acc = torch.empty((F, max_bin, C), dtype=torch.int64, device=dev)
    hist = (torch.empty((F, max_bin, C), dtype=torch.float32, device=dev)
            if finish else None)
    err = _launch(
        dev, _kernels.lib("rows_hist.cu").rows_hist_f32, rows.data_ptr(),
        gh.data_ptr(), mask.data_ptr(), exps.data_ptr(), S, F, max_bin, C,
        rows.element_size(), Bw, FG, R, acc.data_ptr(), _ptr(hist))
    _kernels.check(err, "rows_hist_f32")
    build_histogram_rows_pallas.launches += 1
    return hist if finish else acc


# --------------------------------------------------------------- entry points
def build_histogram_wave(binned_fm: torch.Tensor, slot: torch.Tensor,
                         gh: torch.Tensor, *, max_bin: int, num_slots: int,
                         row_tile: int = ROW_TILE, quant_bins: int = 0,
                         quant_scales: torch.Tensor = None):
    """Histograms for all leaf slots in one pass over the rows (K1; K2
    when `quant_scales` is given).

    Args:
      binned_fm: [F, n] feature-major bin codes, uint8, int16 storage
        of 16-bit codes or int32 (`code_dtype`).
      slot: [n] int32 leaf slot per row; slots outside [0, num_slots)
        are a sentinel that matches nothing.
      gh: [n, C+1] float32 accumulands (gradient, hessian, ...); the LAST
        column is the count mask.
      max_bin: B.  num_slots: NL.  row_tile: n must be a multiple of it.
      quant_bins, quant_scales: quantized mode (ref:
        gradient_discretizer.cpp DiscretizeGradients): gh's channels
        carry k * scale for integers k, which are summed exactly and
        dequantized on the way out; counts count the rows with mask > 0.

    Returns: (hist [NL, F, B, C] float32, counts [NL] float32).
    """
    if row_tile != ROW_TILE:
        raise ValueError(f"row_tile must be {ROW_TILE}")
    _check_wave_inputs(binned_fm, slot, gh, max_bin)
    if quant_scales is not None:
        if quant_bins > 126:
            raise ValueError(f"quant_bins {quant_bins} > 126: the int8 "
                             "grid bound of the JAX kernel")
        quant_scales = _check_scales(quant_scales, gh)
        if gh.device.type == "cpu":
            return build_histogram_wave_int_plain(
                binned_fm, slot, gh, quant_scales, max_bin=max_bin,
                num_slots=num_slots)
        _check_cuda(gh.device)
        return _launch_wave_int(binned_fm, slot, gh, quant_scales, max_bin,
                                num_slots, finish=True)
    if gh.device.type == "cpu":
        return build_histogram_wave_plain(binned_fm, slot, gh,
                                          max_bin=max_bin,
                                          num_slots=num_slots)
    _check_cuda(gh.device)
    return _launch_wave(binned_fm, slot, gh, scale_exps(gh), max_bin,
                        num_slots, finish=True)


build_histogram_wave.launches = 0


def build_histogram_wave_fixed(binned_fm: torch.Tensor, slot: torch.Tensor,
                               gh: torch.Tensor, exps: torch.Tensor, *,
                               max_bin: int, num_slots: int):
    """K1's int64 sums on the caller's grid `exps` ([C+1] int32, e.g. the
    tree's `scale_exps`): (acc [NL, F, B, C], cnt [NL]).  The engines'
    variant of `build_histogram_wave`."""
    _check_wave_inputs(binned_fm, slot, gh, max_bin)
    _check_exps(exps, gh.shape[1], gh.device)
    if gh.device.type == "cpu":
        return build_histogram_wave_plain(
            binned_fm, slot, gh, max_bin=max_bin, num_slots=num_slots,
            exps=exps, fixed=True)
    _check_cuda(gh.device)
    return _launch_wave(binned_fm, slot, gh, exps, max_bin, num_slots,
                        finish=False)


def build_histogram_wave_int(binned_fm: torch.Tensor, slot: torch.Tensor,
                             gh: torch.Tensor, quant_scales: torch.Tensor,
                             *, max_bin: int, num_slots: int):
    """K2's exact int64 sums (acc [NL, F, B, C], cnt [NL]) of the
    quantized integers: the wave engine's form of `build_histogram_wave`
    with `quant_scales`.  The caller keeps the JAX gate: quant_bins <=
    126 and n * quant_bins < 2^31, so the kernel's int32 tile cells
    cannot overflow (its device sums are int64)."""
    _check_wave_inputs(binned_fm, slot, gh, max_bin)
    quant_scales = _check_scales(quant_scales, gh)
    if gh.device.type == "cpu":
        return build_histogram_wave_int_plain(
            binned_fm, slot, gh, quant_scales, max_bin=max_bin,
            num_slots=num_slots, fixed=True)
    _check_cuda(gh.device)
    return _launch_wave_int(binned_fm, slot, gh, quant_scales, max_bin,
                            num_slots, finish=False)


build_histogram_wave_int.launches = 0


def _check_hl(binned_fm, binned_rm, slot, gh, max_bin, num_slots,
              out_slots, row_tile):
    if row_tile != ROW_TILE:
        raise ValueError(f"row_tile must be {ROW_TILE}")
    _check_wave_inputs(binned_fm, slot, gh, max_bin)
    if (binned_rm.dtype != binned_fm.dtype
            or binned_rm.shape != binned_fm.shape[::-1]
            or binned_rm.device != gh.device):
        raise ValueError("binned_rm must be the transpose of binned_fm, of "
                         "its code type, on the data's device")
    if not 1 <= num_slots <= out_slots:
        raise ValueError(f"need 1 <= num_slots ({num_slots}) <= out_slots "
                         f"({out_slots})")
    # the kernel windows the bin axis where a feature does not fit; the
    # plan refuses only slot counts no window can hold
    wave_few_plan(binned_fm.shape[0], max_bin, gh.shape[1] - 1, num_slots)


def build_histogram_wave_hl(binned_fm: torch.Tensor, binned_rm: torch.Tensor,
                            slot: torch.Tensor, gh: torch.Tensor, *,
                            max_bin: int, num_slots: int, out_slots: int,
                            row_tile: int = ROW_TILE):
    """Few-slot variant of `build_histogram_wave` (K3).  `num_slots` is
    the true computed-slot bound; the output is zero-padded to
    `out_slots` rows.  The kernel reads the feature-major bins; of the
    JAX signature's row-major copy `binned_rm [n, F]` (which the plain
    version reads) it checks the shape only, so a view such as
    `binned_fm.t()` will do.  Returns (hist [out_slots, F, B, C],
    counts [out_slots])."""
    _check_hl(binned_fm, binned_rm, slot, gh, max_bin, num_slots, out_slots,
              row_tile)
    if gh.device.type == "cpu":
        return build_histogram_wave_hl_plain(
            binned_fm, binned_rm, slot, gh, max_bin=max_bin,
            num_slots=num_slots, out_slots=out_slots)
    _check_cuda(gh.device)
    return _launch_wave_hl(binned_fm, slot, gh, scale_exps(gh), max_bin,
                           num_slots, out_slots, finish=True)


build_histogram_wave_hl.launches = 0


def build_histogram_wave_hl_fixed(binned_fm: torch.Tensor,
                                  binned_rm: torch.Tensor,
                                  slot: torch.Tensor, gh: torch.Tensor,
                                  exps: torch.Tensor, *, max_bin: int,
                                  num_slots: int, out_slots: int):
    """K3's int64 sums on the caller's grid `exps` (the engines'
    variant of `build_histogram_wave_hl`)."""
    _check_hl(binned_fm, binned_rm, slot, gh, max_bin, num_slots, out_slots,
              ROW_TILE)
    _check_exps(exps, gh.shape[1], gh.device)
    if gh.device.type == "cpu":
        return build_histogram_wave_hl_plain(
            binned_fm, binned_rm, slot, gh, max_bin=max_bin,
            num_slots=num_slots, out_slots=out_slots, exps=exps, fixed=True)
    _check_cuda(gh.device)
    return _launch_wave_hl(binned_fm, slot, gh, exps, max_bin, num_slots,
                           out_slots, finish=False)


def _check_rows_inputs(rows, gh, mask, max_bin, row_tile):
    if row_tile != ROW_TILE:
        raise ValueError(f"row_tile must be {ROW_TILE}")
    _check_codes("rows", rows)
    if gh.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError("gh and mask must be float32")
    if rows.dim() != 2 or gh.dim() != 2 or not 1 <= gh.shape[1] <= 4:
        raise ValueError(f"need rows [S, F] and gh [S, C<=4], got "
                         f"{tuple(rows.shape)}, {tuple(gh.shape)}")
    S = rows.shape[0]
    if gh.shape[0] != S or mask.shape != (S,):
        raise ValueError(f"inconsistent shapes: rows {tuple(rows.shape)}, "
                         f"gh {tuple(gh.shape)}, mask {tuple(mask.shape)}")
    if S % row_tile != 0:
        raise ValueError(f"rows {S} not a multiple of row_tile {row_tile}")
    if not (rows.device == gh.device == mask.device):
        raise ValueError("rows, gh and mask must share a device")
    for name, t in (("rows", rows), ("gh", gh), ("mask", mask)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= max_bin < 1 << 31:
        raise ValueError(f"max_bin must be in [1, 2^31), got {max_bin}")


def build_histogram_rows_pallas(rows: torch.Tensor, gh: torch.Tensor,
                                mask: torch.Tensor, *, max_bin: int,
                                row_tile: int = ROW_TILE) -> torch.Tensor:
    """Single-leaf histogram over row-major rows (K4).

    Args:
      rows: [S, F] bin codes (uint8, int16 storage of 16-bit codes, or
        int32), S a multiple of row_tile.
      gh: [S, C] float32 values.  mask: [S] float32 membership, folded
        into gh.  max_bin: B.

    Returns: hist [F, B, C] float32.
    """
    _check_rows_inputs(rows, gh, mask, max_bin, row_tile)
    if gh.device.type == "cpu":
        return build_histogram_rows_plain(rows, gh, mask, max_bin=max_bin)
    _check_cuda(gh.device)
    return _launch_rows(rows, gh, mask, scale_exps(gh * mask[:, None]),
                        max_bin, finish=True)


build_histogram_rows_pallas.launches = 0


def build_histogram_rows_fixed(rows: torch.Tensor, gh: torch.Tensor,
                               mask: torch.Tensor, exps: torch.Tensor, *,
                               max_bin: int) -> torch.Tensor:
    """K4's int64 sums [F, B, C] on the caller's grid `exps` ([C] int32,
    the tree's `scale_exps`): the leaf-wise engine's variant of
    `build_histogram_rows_pallas`."""
    _check_rows_inputs(rows, gh, mask, max_bin, ROW_TILE)
    _check_exps(exps, gh.shape[1], gh.device)
    if gh.device.type == "cpu":
        return build_histogram_rows_plain(rows, gh, mask, max_bin=max_bin,
                                          exps=exps, fixed=True)
    _check_cuda(gh.device)
    return _launch_rows(rows, gh, mask, exps, max_bin, finish=False)


def build_histogram(binned: torch.Tensor, gh: torch.Tensor,
                    mask: torch.Tensor, *, max_bin: int) -> torch.Tensor:
    """Masked single-leaf histogram, the segment method as `index_add_`
    in float32 (the plain oracle).

    Args:
      binned: [F, n] integer bin codes.  gh: [n, C] values.
      mask: [n] 0/1 leaf membership.  max_bin: B.

    Returns: hist [F, B, C] float32.
    """
    F, n = binned.shape
    C = gh.shape[-1]
    vals = (gh * mask.to(gh.dtype)[:, None]).to(torch.float32)
    ids = (codes_to_int(binned)
           + torch.arange(F, device=binned.device)[:, None] * max_bin)
    out = torch.zeros((F * max_bin, C), dtype=torch.float32,
                      device=binned.device)
    out.index_add_(0, ids.reshape(-1), vals.repeat(F, 1))
    return out.reshape(F, max_bin, C)
