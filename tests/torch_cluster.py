"""Helpers of the PyTorch port's cluster tests (not a test module): spawn
a world of gloo ranks on the CPU that train a set of scenarios in turn
and report each scenario's model text and collective traffic.

One child process per rank joins a FileStore group in a temporary
directory; the port's `reliability.supervisor.supervise` reaps every
child, and the cluster has a deadline, so a hung rank cannot hold the
test worker.
"""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
spec = json.load(open(sys.argv[2]))
rank = int(sys.argv[3])
import numpy as np
import torch
torch.set_num_threads(1)
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.distributed import join_cluster, leave_cluster
from lightgbm_tpu_torch.parallel import current_network
join_cluster(["localhost:0"] * spec["world"], rank=rank,
             initialize_timeout=spec["timeout"], device_type="cpu",
             store_path=spec["store"])
net = current_network()
out = {}
for name, (params, rounds, data) in spec["scenarios"].items():
    path = spec["data"][data]
    if path.endswith(".sparse.npz"):
        import scipy.sparse as sps
        X = sps.load_npz(path).tocsr()
        y = np.load(path.replace(".sparse.npz", ".y.npy"))
    else:
        d = np.load(path)
        X, y = d["X"], d["y"]
    fields = {k: np.load(f"{path}.{k}.npy") for k in ("group", "position")
              if os.path.exists(f"{path}.{k}.npy")}
    b0, c0 = net.bytes, net.calls
    b = tlgb.train(params, tlgb.Dataset(X, label=y, params=params,
                                        **fields), rounds)
    g = b._gbdt
    out[name] = {"model": b.model_to_string(),
                 "bytes": net.bytes - b0, "calls": net.calls - c0,
                 "block": (None if g.block is None else
                           [g.block.start, g.block.stop,
                            len(g.block.features)]),
                 "voting": g.voting is not None,
                 "rows": None if g.shard is None else g.shard.count,
                 "strategy": g.growth_strategy,
                 "bundled": g.bundle_plan is not None}
leave_cluster()
with open(spec["out"] % rank, "w") as f:
    json.dump(out, f)
"""


def query_sizes(n, seed=5, lo=4, hi=40):
    """Query sizes of `n` rows, each drawn from [lo, hi] (the last one
    takes the rest)."""
    rng = np.random.RandomState(seed)
    out = []
    while n - sum(out) > hi:
        out.append(int(rng.randint(lo, hi + 1)))
    out.append(n - sum(out))
    return out


def positions_of(sizes, cycle=12):
    """Each row's position in its query, modulo `cycle`."""
    sizes = np.asarray(sizes, np.int64)
    starts = np.repeat(np.cumsum(sizes) - sizes, sizes)
    return (np.arange(sizes.sum()) - starts) % cycle


def save_data(tmp, kind, X, y, **fields):
    """Write one data kind for the children: an npz, or a CSR matrix
    (scipy-sparse X) beside its labels, and beside either the Dataset
    `fields` given (group: the query sizes, position)."""
    if hasattr(X, "tocsr"):
        import scipy.sparse as sps
        path = os.path.join(tmp, f"{kind}.sparse.npz")
        sps.save_npz(path, X.tocsr())
        np.save(path.replace(".sparse.npz", ".y.npy"), y)
    else:
        path = os.path.join(tmp, f"{kind}.npz")
        np.savez(path, X=X, y=y)
    for k, v in fields.items():
        if v is not None:
            np.save(f"{path}.{k}.npy", np.asarray(v, np.int64))
    return path


def run_cluster(world, tmp, scenarios, data, deadline_s=150, child=CHILD):
    """Spawn `world` ranks of the script `child` (argv: repo root, spec
    path, rank; default CHILD) that train `scenarios` {name: (params,
    rounds, data kind)} over `data` {kind: path}; returns [per rank
    {name: report}].  The port's `supervise` reaps them: a failed rank
    ends the others, the deadline ends all."""
    from lightgbm_tpu_torch.reliability.supervisor import supervise
    os.makedirs(tmp, exist_ok=True)
    spec = {"world": world, "store": os.path.join(tmp, "store"),
            "timeout": deadline_s, "data": data,
            "out": os.path.join(tmp, "out_%d.json"),
            "scenarios": scenarios}
    spec_path = os.path.join(tmp, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    script = os.path.join(tmp, "child.py")
    with open(script, "w") as f:
        f.write(child)
    logs = [os.path.join(tmp, f"rank{r}.log") for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, script, ROOT, spec_path, str(r)],
                    stdout=f, stderr=subprocess.STDOUT))
    finally:
        res = supervise(procs, logs, deadline_s, poll_interval=0.1)
    if not res.ok or len(procs) != world:
        raise AssertionError(res.describe())
    out = []
    for r in range(world):
        with open(spec["out"] % r) as f:
            out.append(json.load(f))
    return out
