#!/usr/bin/env python3
"""Time the gather kernel's packed layouts on the main path's operators.

    python3 tools/torch_sell_lanes.py [--grids 512,2048]
        [--windows 256,512,2048,4096,0] [--baseline SRC]

For each grid it sets up the main path in f32 (chip_smoke.py's options;
6 levels at 512^2, 10 above, as chip_smoke.py runs them), uploads it, and
takes the widest TELL operator (by stored slots) and the coarse inverse's
ELL.  On each it times ``csrc/sell_spmv.cu`` over packed copies built
as the port builds them (the lanes ``choose_lanes`` gives, the rows
sorted by length within runs of ``SORT_WINDOW`` rows) against copies
with every other lane count of ``LANES``, and with the rows sorted
within windows of each of ``--windows`` rows instead (SELL-C-sigma's
sigma; 0: over all n rows).  Each packed copy is first held to
``sell_spmv_plain`` bit for bit.  With ``--baseline`` it also times
another TELL kernel source with the C interface of the earlier
one-thread-a-row ``tell_spmv.cu`` (``tell_spmv_f32(data, cols, x, y, n,
K, stream)`` over the ``[K, n]`` slots) on the same operator, and it
times cuSPARSE's CSR product (``torch.sparse_csr_tensor @ x``).

Times are device times by CUDA graph replay (``chip_smoke.graph_ms``)
over enough copies of the operator to fill twice the L2, in the order
default, variant, variant, default (the better of each pair); bound as
``chip_smoke.py::measure`` computes it (the nonzeros' bytes).  One JSON
line per operator and variant; ptxas's register and spill counts of the
kernel first.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_baseline(cuda, src):
    """The baseline TELL kernel's f32 entry point, built by nvcc."""
    path = cuda.build("tell_spmv", os.path.abspath(src), "baseline")[0]
    fn = ctypes.CDLL(path).tell_spmv_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    return fn


def compare(torch, np, sell, chip_smoke, baseline, rng, label, op, windows):
    """Every packed layout of ``op`` against the default one, timed in
    turns, and the baseline kernel and cuSPARSE beside them."""
    from pflare_tpu_torch import cuda

    host = op.to_scipy()
    n, n_cols = op.shape
    dev = op.data.device
    x = torch.as_tensor(rng.standard_normal(n_cols), dtype=torch.float32,
                        device=dev)
    copies = min(chip_smoke.R, max(1, math.ceil(
        2 * chip_smoke.L2_BYTES / op.packed.nbytes)))
    mats = [op] + [type(op)(op.pattern, op.data.clone(), op.cols.clone())
                   for _ in range(copies - 1)]
    default = op.packed.lanes
    layouts = {f"L={L}": sell.sell_index(op, L) for L in sell.LANES}
    layouts.update((f"L={default} window={w or 'n'}",
                    sell.sell_index(op, default, window=w or None))
                   for w in windows if w != sell.SORT_WINDOW)
    fns = {}
    for tag, idx in layouts.items():
        packs = [sell.pack(M, index=idx) for M in mats]
        y = sell.sell_spmv_cuda(packs[0], x)
        if not torch.equal(y, sell.sell_spmv_plain(packs[0], x)):
            raise SystemExit(f"{label} {tag}: the kernel differs from its "
                             "plain version")
        fns[tag] = ([lambda P=P: sell.sell_spmv_cuda(P, x) for P in packs],
                    packs[0].data.numel())
    T = 4
    x_read = int(np.count_nonzero(np.bincount(host.indices,
                                              minlength=n_cols)))
    bound_ms = ((host.nnz * (T + 4) + (n + x_read) * T)
                / chip_smoke.HBM_BYTES_S * 1e3)
    base = {"grid_operator": label, "container": type(op).__name__,
            "n": n, "n_cols": n_cols, "K": op.pattern.K, "nnz": host.nnz,
            "stored_slots": op.data.numel(), "default_lanes": default,
            "copies": copies, "bound_ms": bound_ms}
    key = f"L={default}"
    for tag, (fn, slots) in fns.items():
        if tag == key:
            continue
        t = [chip_smoke.graph_ms(torch, f)
             for f in (fns[key][0], fn, fn, fns[key][0])]
        print(json.dumps({**base, "variant": tag, "packed_slots": slots,
                          "default_packed_slots": fns[key][1],
                          "default_ms": min(t[0], t[3]),
                          "variant_ms": min(t[1], t[2])}), flush=True)
    extra = {}
    csrs = [torch.sparse_csr_tensor(
        torch.as_tensor(host.indptr, dtype=torch.int32),
        torch.as_tensor(host.indices, dtype=torch.int32),
        torch.as_tensor(host.data, dtype=torch.float32),
        size=host.shape).to(dev) for _ in range(copies)]
    extra["cusparse"] = [lambda C=C: C @ x for C in csrs]
    if baseline is not None:
        tells = [(M.data, M.cols) if isinstance(M, sell.TELL) else
                 (M.data.T.contiguous(), M.cols.T.contiguous())
                 for M in mats]

        def old(data, cols):
            y = torch.empty(n, dtype=torch.float32, device=dev)
            rc = baseline(data.data_ptr(), cols.data_ptr(), x.data_ptr(),
                          y.data_ptr(), n, data.shape[0],
                          cuda.stream_handle(dev))
            if rc:
                raise SystemExit(f"baseline kernel: CUDA error {rc}")
            return y

        y = old(*tells[0])
        ref = sell.sell_spmv_cuda(op.packed, x)
        torch.cuda.synchronize()
        if float((y - ref).abs().max()) > 1e-5 * float(ref.abs().max()):
            raise SystemExit(f"{label}: the baseline kernel disagrees")
        extra["baseline"] = [lambda d=d, c=c: old(d, c) for d, c in tells]
    for tag, fn in extra.items():
        t = [chip_smoke.graph_ms(torch, f)
             for f in (fns[key][0], fn, fn, fns[key][0])]
        print(json.dumps({**base, "variant": tag, "default_ms":
                          min(t[0], t[3]), "variant_ms": min(t[1], t[2])}),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grids", default="512,2048",
                    help="comma-separated grid sides")
    ap.add_argument("--windows", default="256,512,2048,4096,0",
                    help="comma-separated sort windows (multiples of 32; "
                         "0 sorts over all rows)")
    ap.add_argument("--baseline", default=None,
                    help="a TELL kernel source with the C interface "
                         "tell_spmv_f32(data, cols, x, y, n, K, stream)")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke
    import pflare_tpu_torch as tpf
    from pflare_tpu_torch import cuda
    from pflare_tpu_torch.sparse import ELL, TELL
    from pflare_tpu_torch.sparse import ell as sell

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"# {smi.splitlines()[0]}")
    ptxas = cuda.build("sell_spmv", tag="ptxas", flags=("-Xptxas", "-v"))[1]
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
    spills = [ln.strip() for ln in ptxas.splitlines()
              if re.search(r"[1-9]\d* bytes spill", ln)]
    print(f"# ptxas: {len(regs)} kernels, registers "
          f"{min(regs, default=0)}..{max(regs, default=0)}, spill lines: "
          f"{spills or 'none'}", flush=True)
    baseline = load_baseline(cuda, args.baseline) if args.baseline else None
    windows = [int(w) for w in args.windows.split(",") if w]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    for grid in (int(g) for g in args.grids.split(",")):
        pc = tpf.PCAIR(chip_smoke.bench_options(
            tpf, max_levels=6 if grid <= 512 else 10),
            dtype=torch.float32, device=dev)
        pc.setup(tpf.adv_diff_2d(grid).astype(np.float32))
        dh = pc.upload()
        tells = [(f"level {i} {k}", op) for i, lev in enumerate(dh.levels)
                 for k, op in lev.items() if isinstance(op, TELL)]
        name, widest = max(tells, key=lambda lo: lo[1].data.numel())
        coarse = dh.coarse_inv.mat
        assert isinstance(coarse, ELL)
        for label, op in ((f"{grid}^2 {name}", widest),
                          (f"{grid}^2 coarse inverse", coarse)):
            compare(torch, np, sell, chip_smoke, baseline, rng, label, op,
                    windows)
        del pc, dh, tells, widest, coarse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
