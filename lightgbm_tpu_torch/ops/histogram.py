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

Launch plans.  K1 and K4 take their shapes from the planners here
(`wave_part_plan`, `rows_plan`), which the CPU tests check.  K1
partitions the computed rows by slot on the card and walks work items
of (slot, feature group, at most R rows).  It reads the feature-major
bins only: its partition pass transposes each computed row into a
packed row-major copy, so the row-major `binned_rm` that K3 and K4 read
is not needed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _kernels

# Shared memory one block may hold on an H100 (227 KB); the kernels' tile
# rule below and `wave_hl_fits` budget against it.
SMEM_LIMIT = 232448
ROW_TILE = 512


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
    """Shared-memory budget rule of K3 (replaces the TPU VMEM rule
    `_hl_fits` of learner/wave.py): every computed slot's histograms of
    at least one feature, plus the slot counts, fit one block."""
    return num_slots * (max_bin * C * 8 + 8) <= SMEM_LIMIT


def wave_slot_pad(num_slots: int) -> int:
    """Slot-axis padding of the wave engine's static slot bounds."""
    if num_slots <= 128:
        return max(8, (num_slots + 7) // 8 * 8)
    return (num_slots + 127) // 128 * 128


def wave_tile(num_features: int, max_bin: int, num_slots: int, C: int,
              cell_bytes: int = 8):
    """(slot group, feature group) of one K2 block's shared-memory tile:
    SG * FG * B * C histogram cells plus SG counts (K2's int32 cells pass
    cell_bytes=4)."""
    cb = cell_bytes
    SG = min(num_slots, SMEM_LIMIT // (max_bin * C * cb + cb))
    FG = min(num_features, (SMEM_LIMIT - cb * SG) // (SG * max_bin * C * cb))
    if SG < 1 or FG < 1:
        raise ValueError(f"max_bin={max_bin} with {C} channels does not fit "
                         "the kernel's shared-memory tile")
    return SG, FG


def hl_feature_group(num_features: int, max_bin: int, num_slots: int,
                     C: int) -> int:
    """Features per K3 block: all `num_slots` slots of FG features."""
    return min(num_features,
               (SMEM_LIMIT - 8 * num_slots) // (num_slots * max_bin * C * 8))


# K1 and K4 tiles: (features x B x C) int64 cells plus one count cell in
# at most this many bytes, so several blocks share an SM.
TILE_BYTES = 32 * 1024
TILE_FEATURES = 8    # most features of one tile (kTileFeatures)
UNIT_ROWS = 512      # rows of one warp's chunk in K1's partition passes
PART_WARPS = 8       # warps of one partition block, where they fit
K4_MIN_ROWS = 512    # K4: rows of one block at least
K4_BLOCKS = 2048     # K4: blocks aimed at for large segments


def tile_feature_group(num_features: int, max_bin: int, C: int) -> int:
    """Features per K1 work item and per K4 block: the fewest equal
    groups of at most TILE_FEATURES whose (FG x B x C) int64 tile and
    count cell fit TILE_BYTES (one feature per group, up to SMEM_LIMIT,
    where not even one fits)."""
    per = max_bin * C * 8
    fg_max = min(TILE_FEATURES, (TILE_BYTES - 8) // per)
    if fg_max < 1:
        fg_max = 1 if per + 8 <= SMEM_LIMIT else 0
    if fg_max < 1:
        raise ValueError(f"max_bin={max_bin} with {C} channels does not fit "
                         "the kernel's shared-memory tile")
    groups = -(-num_features // fg_max)
    return -(-num_features // groups)


class WavePlan(NamedTuple):
    """K1's launch plan: PW warps per partition block (each keeps NL
    int32 counters in shared memory); FG features and at most R rows per
    work item; U warp units of UR rows in the partition; rows
    packed at Fp bytes and fixed-point gh at QS int64s per row; bytes of
    scratch, of a histogram tile and of a partition block's counters."""
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


def wave_part_plan(n: int, num_features: int, max_bin: int, C: int,
                   num_slots: int) -> WavePlan:
    """K1's plan (`wave_hist.cu` wave_hist_f32 and wave_part_scratch use
    the same layout)."""
    FG = tile_feature_group(num_features, max_bin, C)
    R = min(4096, max(256, n // 1024))
    U = -(-n // UNIT_ROWS)
    Fp = -(-num_features // 16) * 16
    QS = (C + 2) // 2 * 2
    ints = num_slots * U + num_slots + 2 * (num_slots + 1)
    scratch = (-(-ints * 4 // 256) * 256 + -(-n * Fp // 256) * 256
               + n * QS * 8)
    PW = min(PART_WARPS, SMEM_LIMIT // (4 * num_slots))
    if PW < 1:
        raise ValueError(f"{num_slots} slots exceed the partition's shared "
                         "memory")
    return WavePlan(PW, FG, R, UNIT_ROWS, U, Fp, QS, scratch,
                    8 * (FG * max_bin * C + 1), 4 * PW * num_slots)


def rows_plan(S: int, num_features: int, max_bin: int, C: int):
    """K4's launch plan (FG, rows_per_block): feature groups from the
    tile budget, and row chunks of at least K4_MIN_ROWS rows (a multiple
    of 512) sized so that about K4_BLOCKS blocks cover a large segment."""
    FG = tile_feature_group(num_features, max_bin, C)
    groups = -(-num_features // FG)
    per = -(-S // max(1, K4_BLOCKS // groups))
    R = max(K4_MIN_ROWS, -(-per // 512) * 512)
    return FG, R


# --------------------------------------------------------------- fixed point
def scale_exps(gh: torch.Tensor) -> torch.Tensor:
    """[k] int32 exponents E with max|gh[:, c]| * n <= 2^E for gh [n, k]
    (frexp of the float32 product, clamped to [-38, 62]): the grid of
    every fixed-point histogram of these rows or of any subset of them."""
    n = gh.shape[0]
    amax = (torch.linalg.vector_norm(gh, float("inf"), dim=0) if n
            else gh.new_zeros(gh.shape[1]))
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


def _check_wave_inputs(binned: torch.Tensor, slot: torch.Tensor,
                       gh: torch.Tensor, max_bin: int, row_major: bool):
    if binned.dtype != torch.uint8:
        raise TypeError(f"binned must be uint8, got {binned.dtype}")
    if slot.dtype != torch.int32:
        raise TypeError(f"slot must be int32, got {slot.dtype}")
    if gh.dtype != torch.float32:
        raise TypeError(f"gh must be float32, got {gh.dtype}")
    if gh.dim() != 2 or gh.shape[1] < 2:
        raise ValueError(f"gh must be [n, C+1], got {tuple(gh.shape)}")
    n = gh.shape[0]
    shape_ok = (binned.dim() == 2
                and binned.shape[0 if row_major else 1] == n
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
    if max_bin < 1:
        raise ValueError(f"max_bin must be positive, got {max_bin}")


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
        b = binned_fm[f].to(torch.int64)
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
        b = rows[:, f].to(torch.int64)
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
    F, n = binned_fm.shape
    C = gh.shape[1] - 1
    plan = wave_part_plan(n, F, max_bin, C, num_slots)
    dev = gh.device
    acc = torch.empty((num_slots, F, max_bin, C), dtype=torch.int64,
                      device=dev)
    cnt_acc = torch.empty(num_slots, dtype=torch.int64, device=dev)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=dev)
    hist = counts = None
    if finish:
        hist = torch.empty((num_slots, F, max_bin, C), dtype=torch.float32,
                           device=dev)
        counts = torch.empty(num_slots, dtype=torch.float32, device=dev)
    err = _launch(
        dev, _kernels.lib().wave_hist_f32, binned_fm.data_ptr(),
        slot.data_ptr(), gh.data_ptr(), exps.data_ptr(), n, F, max_bin, C,
        num_slots, plan.UR, plan.PW, plan.FG, plan.R, scratch.data_ptr(),
        plan.scratch_bytes, acc.data_ptr(), cnt_acc.data_ptr(), _ptr(hist),
        _ptr(counts))
    _kernels.check(err, "wave_hist_f32")
    build_histogram_wave.launches += 1
    return (hist, counts) if finish else (acc, cnt_acc)


def _launch_wave_int(binned_fm, slot, gh, scales, max_bin, num_slots,
                     finish):
    """K2 on the card: float32 (hist, counts) when `finish`, else the
    int32 sums widened to int64."""
    F, n = binned_fm.shape
    C = gh.shape[1] - 1
    SG, FG = wave_tile(F, max_bin, num_slots, C, cell_bytes=4)
    dev = gh.device
    acc = torch.empty((num_slots, F, max_bin, C), dtype=torch.int32,
                      device=dev)
    cnt_acc = torch.empty(num_slots, dtype=torch.int32, device=dev)
    hist = counts = None
    if finish:
        hist = torch.empty((num_slots, F, max_bin, C), dtype=torch.float32,
                           device=dev)
        counts = torch.empty(num_slots, dtype=torch.float32, device=dev)
    err = _launch(
        dev, _kernels.lib().wave_hist_i32, binned_fm.data_ptr(),
        slot.data_ptr(), gh.data_ptr(), scales.data_ptr(), n, F, max_bin, C,
        num_slots, SG, FG, acc.data_ptr(), cnt_acc.data_ptr(), _ptr(hist),
        _ptr(counts))
    _kernels.check(err, "wave_hist_i32")
    build_histogram_wave_int.launches += 1
    if finish:
        return hist, counts
    return acc.to(torch.int64), cnt_acc.to(torch.int64)


def _launch_wave_hl(binned_rm, slot, gh, exps, max_bin, num_slots,
                    out_slots, finish):
    """K3 on the card: float32 when `finish`, else the int64 sums."""
    n, F = binned_rm.shape
    C = gh.shape[1] - 1
    FG = hl_feature_group(F, max_bin, num_slots, C)
    dev = gh.device
    acc = torch.empty((out_slots, F, max_bin, C), dtype=torch.int64,
                      device=dev)
    cnt_acc = torch.empty(out_slots, dtype=torch.int64, device=dev)
    hist = counts = None
    if finish:
        hist = torch.empty((out_slots, F, max_bin, C), dtype=torch.float32,
                           device=dev)
        counts = torch.empty(out_slots, dtype=torch.float32, device=dev)
    err = _launch(
        dev, _kernels.lib().wave_hist_hl_f32, binned_rm.data_ptr(),
        slot.data_ptr(), gh.data_ptr(), exps.data_ptr(), n, F, max_bin, C,
        num_slots, out_slots, FG, acc.data_ptr(), cnt_acc.data_ptr(),
        _ptr(hist), _ptr(counts))
    _kernels.check(err, "wave_hist_hl_f32")
    build_histogram_wave_hl.launches += 1
    return (hist, counts) if finish else (acc, cnt_acc)


def _launch_rows(rows, gh, mask, exps, max_bin, finish):
    """K4 on the card: float32 [F, B, C] when `finish`, else int64."""
    S, F = rows.shape
    C = gh.shape[1]
    FG, R = rows_plan(S, F, max_bin, C)
    dev = gh.device
    acc = torch.empty((F, max_bin, C), dtype=torch.int64, device=dev)
    hist = (torch.empty((F, max_bin, C), dtype=torch.float32, device=dev)
            if finish else None)
    err = _launch(
        dev, _kernels.lib("rows_hist.cu").rows_hist_f32, rows.data_ptr(),
        gh.data_ptr(), mask.data_ptr(), exps.data_ptr(), S, F, max_bin, C,
        FG, R, acc.data_ptr(), _ptr(hist))
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
      binned_fm: [F, n] uint8 feature-major bin codes.
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
    _check_wave_inputs(binned_fm, slot, gh, max_bin, row_major=False)
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
    _check_wave_inputs(binned_fm, slot, gh, max_bin, row_major=False)
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
    126 and n * quant_bins < 2^31, so the kernel's int32 sums cannot
    overflow."""
    _check_wave_inputs(binned_fm, slot, gh, max_bin, row_major=False)
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
    _check_wave_inputs(binned_rm, slot, gh, max_bin, row_major=True)
    if binned_fm.shape != binned_rm.shape[::-1]:
        raise ValueError("binned_fm must be the transpose of binned_rm")
    if not 1 <= num_slots <= out_slots:
        raise ValueError(f"need 1 <= num_slots ({num_slots}) <= out_slots "
                         f"({out_slots})")
    if not wave_hl_fits(max_bin, num_slots, gh.shape[1] - 1):
        raise ValueError(f"{num_slots} slots at max_bin={max_bin} exceed "
                         "the few-slot kernel's shared memory")


def build_histogram_wave_hl(binned_fm: torch.Tensor, binned_rm: torch.Tensor,
                            slot: torch.Tensor, gh: torch.Tensor, *,
                            max_bin: int, num_slots: int, out_slots: int,
                            row_tile: int = ROW_TILE):
    """Few-slot variant of `build_histogram_wave` (K3).  `num_slots` is
    the true computed-slot bound; the output is zero-padded to
    `out_slots` rows.  The kernel reads the row-major copy `binned_rm
    [n, F]`.  Returns (hist [out_slots, F, B, C], counts [out_slots])."""
    _check_hl(binned_fm, binned_rm, slot, gh, max_bin, num_slots, out_slots,
              row_tile)
    if gh.device.type == "cpu":
        return build_histogram_wave_hl_plain(
            binned_fm, binned_rm, slot, gh, max_bin=max_bin,
            num_slots=num_slots, out_slots=out_slots)
    _check_cuda(gh.device)
    return _launch_wave_hl(binned_rm, slot, gh, scale_exps(gh), max_bin,
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
    return _launch_wave_hl(binned_rm, slot, gh, exps, max_bin, num_slots,
                           out_slots, finish=False)


def _check_rows_inputs(rows, gh, mask, max_bin, row_tile):
    if row_tile != ROW_TILE:
        raise ValueError(f"row_tile must be {ROW_TILE}")
    if rows.dtype != torch.uint8:
        raise TypeError(f"rows must be uint8, got {rows.dtype}")
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
    if max_bin < 1:
        raise ValueError(f"max_bin must be positive, got {max_bin}")


def build_histogram_rows_pallas(rows: torch.Tensor, gh: torch.Tensor,
                                mask: torch.Tensor, *, max_bin: int,
                                row_tile: int = ROW_TILE) -> torch.Tensor:
    """Single-leaf histogram over row-major rows (K4).

    Args:
      rows: [S, F] uint8 bin codes, S a multiple of row_tile.
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
    ids = (binned.to(torch.int64)
           + torch.arange(F, device=binned.device)[:, None] * max_bin)
    out = torch.zeros((F * max_bin, C), dtype=torch.float32,
                      device=binned.device)
    out.index_add_(0, ids.reshape(-1), vals.repeat(F, 1))
    return out.reshape(F, max_bin, C)
