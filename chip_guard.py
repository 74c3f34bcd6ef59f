"""Check on one CUDA card that the port's hand-written kernels (K1-K4)
write only inside the buffers their wrappers allocate and leave their
inputs as they were:

    python3 chip_guard.py

Every buffer that `lightgbm_tpu_torch/ops/histogram.py` allocates on the
card (the int64 sums, the counts, K1's and K2's partition scratch, the
float32 finish outputs) is carved from a larger buffer with a band of
GUARD_BYTES of 0xA5 on each side.  After each launch the card is
synchronized, both bands must still read 0xA5, and the byte sums of the
launch's inputs (codes, slots, gh, exps or scales; rows, gh, mask and
exps for K4) must equal their sums before it.  It runs chip_smoke.py's
K1 and K3 kernel shapes, then trains on chip_smoke.py's bench Dataset
(1M x 28, 255 leaves): the main path, path A (quantized), path B
(leaf-wise), bagging with feature_fraction, extra trees, max_bin=1023 on
the wave, quantized and leaf-wise engines, and the efb phase's one-hot
CSR on the wave and quantized engines.  Prints one progress line a run
and, last, one JSON object with the launches checked per kernel and
every violation; exits 1 on a violation or without a card.  About 100
s on an H100 (kernel build included).
"""

import json
import os
import sys
import time

import numpy as np
import torch

GUARD_BYTES = 1 << 16
PATTERN = 0xA5


class GuardedTorch:
    """`torch` for histogram.py, with `empty` on the card carving each
    tensor out of a guarded buffer (recorded in `bands`)."""

    def __init__(self):
        self.bands = []

    def empty(self, *shape, dtype=None, device=None, **kw):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list,
                                                     torch.Size)):
            shape = tuple(shape[0])
        dev = None if device is None else torch.device(device)
        if dev is None or dev.type != "cuda" or kw.get("pin_memory"):
            return torch.empty(shape, dtype=dtype, device=device, **kw)
        dt = dtype or torch.float32
        nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty(
            (), dtype=dt).element_size()
        body = (nbytes + 255) // 256 * 256
        buf = torch.full((2 * GUARD_BYTES + body,), PATTERN,
                         dtype=torch.uint8, device=dev)
        self.bands.append((buf, nbytes, tuple(shape), str(dt)))
        return buf[GUARD_BYTES:GUARD_BYTES + nbytes].view(dt).view(shape)

    def __getattr__(self, name):
        return getattr(torch, name)


def byte_sum(t: torch.Tensor) -> int:
    return int(t.contiguous().view(torch.uint8).sum(dtype=torch.int64))


def guarded(name, fn, proxy, stats, n_inputs):
    """`fn` (a launch wrapper whose first `n_inputs` arguments are its
    inputs), checked after every call."""
    def call(*args, **kw):
        proxy.bands.clear()
        inputs = [a for a in args[:n_inputs] if isinstance(a, torch.Tensor)]
        before = [byte_sum(t) for t in inputs]
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        stats["launches"][name] = stats["launches"].get(name, 0) + 1
        shapes = [list(a.shape) if isinstance(a, torch.Tensor) else a
                  for a in args]
        for buf, nbytes, shape, dt in proxy.bands:
            low = int((buf[:GUARD_BYTES] != PATTERN).sum())
            high = int((buf[GUARD_BYTES + nbytes:] != PATTERN).sum())
            if low or high:
                stats["violations"].append({
                    "kernel": name, "buffer": list(shape), "dtype": dt,
                    "bytes_changed_below": low, "bytes_changed_above": high,
                    "args": shapes})
        if [byte_sum(t) for t in inputs] != before:
            stats["violations"].append({"kernel": name,
                                        "input_changed": True,
                                        "args": shapes})
        return out
    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_guard: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import histogram as H

    proxy = GuardedTorch()
    H.torch = proxy
    stats = {"launches": {}, "violations": []}
    for name, attr in (("K1", "_launch_wave"), ("K2", "_launch_wave_int"),
                       ("K3", "_launch_wave_hl"), ("K4", "_launch_rows")):
        setattr(H, attr, guarded(name, getattr(H, attr), proxy, stats, 4))

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)

    def progress(run):
        print(json.dumps({"run": run, "launches": dict(stats["launches"]),
                          "violations": len(stats["violations"]),
                          "t_s": time.perf_counter() - t0}), flush=True)

    for NL, uneven, n in cs.K1_SHAPES:
        b, _, s, gh = cs.kernel_inputs(NL, dev, seed=NL + n % 7, n=n,
                                       uneven=uneven)
        H.build_histogram_wave(b, s, gh, max_bin=cs.B, num_slots=NL)
    for S, hot in cs.K3_SHAPES:
        b, brm, s, gh = cs.kernel_inputs(S, dev, seed=S, hot=hot)
        H.build_histogram_wave_hl(b, brm, s, gh, max_bin=cs.B, num_slots=S,
                                  out_slots=H.wave_slot_pad(S))
    progress("kernel_shapes")

    (X, y, _, _), ds = cs.bench_rows(lgb)
    params = dict(cs.BENCH_PARAMS)
    for name, extra, it in (
            ("main_path", {}, 4),
            ("path_a_quantized", {"use_quantized_grad": True}, 4),
            ("path_b_leafwise", {"tpu_growth_strategy": "leafwise"}, 2),
            ("bagging", {"bagging_fraction": 0.8, "bagging_freq": 1,
                         "feature_fraction": 0.8}, 3),
            ("extra_trees", {"extra_trees": True}, 3)):
        lgb.train(dict(params, **extra), ds, it)
        progress(name)
    wide = lgb.Dataset(X, label=y, params=dict(params, max_bin=1023))
    for name, extra, it in (("wide_wave", {}, 3),
                            ("wide_quantized", {"use_quantized_grad": True},
                             3),
                            ("wide_leafwise",
                             {"tpu_growth_strategy": "leafwise"}, 1)):
        lgb.train(dict(params, max_bin=1023, **extra), wide, it)
        progress(name)
    del wide
    csr, ye = cs.make_onehot_csr(1_000_000)
    efb = lgb.Dataset(csr, label=ye)
    for name, extra, it in (("efb_wave", {}, 3),
                            ("efb_quantized", {"use_quantized_grad": True},
                             2)):
        lgb.train(dict(params, **extra), efb, it)
        progress(name)
    print(cs.card_line(), flush=True)
    print(json.dumps({"guard_bytes": GUARD_BYTES, **stats,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 1 if stats["violations"] else 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
