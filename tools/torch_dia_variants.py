#!/usr/bin/env python3
"""Time variants of the port's DIA SpMV kernel against the kernel as it is.

    python3 tools/torch_dia_variants.py [--grids 512,2048] [--baseline SRC]

Builds ``pflare_tpu_torch/csrc/dia_spmv.cu`` with nvcc as it is and, as
``tools/torch_banded_skip.py`` does, with its source text edited into a
variant:

- ``zero_skip``: a slot whose data is 0 skips its read of x and its FMA
  (a thread's 16-byte read of x is skipped when all its rows' data is 0);
- ``threads128``: blocks of 128 threads, not 256;
- ``rows_f64_4``: four f64 rows a thread, not two (timed on the f64
  operator only);

and, with ``--baseline``, another source with the same C interface (an
earlier version of the kernel, tag ``baseline``).  For each grid it sets
up the main path's hierarchy (the options of chip_smoke.py) to two
levels, so that level 0 is a full level, and times every build on the
top A (f32 and f64) and on the DIA operators of level 0 (f32): A_ff,
A_fc, R and P, the masked operators whose slots are mostly zeros.  Each
build is first held against the plain version (relative error <= 1e-6 in
f32, 1e-13 in f64).  Times are device times by CUDA graph replay
(``chip_smoke.graph_ms``) over enough copies of the operator to fill
twice the L2, as chip_smoke.py times its kernels, in the order as-is,
variant, variant, as-is; the better of each pair is printed, one JSON
line per operator and variant.  The as-is build is compiled with
``-Xptxas -v`` and the largest register count and any spills of its
instantiations are printed first.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each variant: (old text, new text) edits of the source, each old text
# found exactly once
ZERO_SKIP = [
    ("      load_vec<T, V, false>(x + j, xv[u]);\n",
     "      bool any = false;\n"
     "#pragma unroll\n"
     "      for (int v = 0; v < V; ++v) any |= d[u][v] != T(0);\n"
     "      if (any) {\n"
     "        load_vec<T, V, false>(x + j, xv[u]);\n"
     "      } else {\n"
     "#pragma unroll\n"
     "        for (int v = 0; v < V; ++v) xv[u][v] = T(0);\n"
     "      }\n"),
    ("const bool read = !kEdge || (c >= 0 && c < n_cols);",
     "const bool read = (!kEdge || (c >= 0 && c < n_cols)) &&\n"
     "                          d[u][v] != T(0);"),
    ("for (int v = 0; v < V; ++v) acc[v] += d[u][v] * xv[u][v];",
     "for (int v = 0; v < V; ++v) {\n"
     "      if (d[u][v] != T(0)) acc[v] += d[u][v] * xv[u][v];\n"
     "    }"),
]
VARIANTS = {"zero_skip": ZERO_SKIP,
            "threads128": [("constexpr int kThreads = 256;",
                            "constexpr int kThreads = 128;")],
            "rows_f64_4": [("static constexpr int rows = 2;",
                            "static constexpr int rows = 4;")]}
F64_ONLY = {"rows_f64_4"}


def variant_source(text: str, edits, path: str) -> str:
    """Write ``text`` with ``edits`` applied to ``path``; returns it."""
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{old!r} is not in the kernel source once")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return path


def matvec(torch, np, cuda, lib, D, x):
    """``D @ x`` through the DIA build ``lib``, without the wrapper's
    checks and launch count."""
    n_rows, n_cols = D.shape
    y = torch.empty(n_rows, dtype=D.data.dtype, device=D.data.device)
    offs = np.ascontiguousarray(D.offsets, dtype=np.int64)
    cuda.launch("dia_spmv", D.data.dtype, D.data.data_ptr(), x.data_ptr(),
                y.data_ptr(), n_rows, n_cols, offs.ctypes.data,
                len(D.offsets), cuda.stream_handle(D.data.device), lib=lib)
    return y


def compare(torch, np, cuda, tdia, chip_smoke, libs, rng, grid, name, D):
    """Every build against the plain version, then each variant timed in
    turns with the as-is build, on one operator."""
    n_rows, n_cols = D.shape
    x = torch.as_tensor(rng.standard_normal(n_cols), dtype=D.data.dtype,
                        device=D.data.device)
    ref = tdia.dia_spmv_plain(D.data, D.offsets, x, n_rows, n_cols)
    tol = 1e-6 if D.data.dtype == torch.float32 else 1e-13
    T = D.data.element_size()
    op_bytes = D.data.numel() * T
    copies = min(chip_smoke.R,
                 max(1, math.ceil(2 * chip_smoke.L2_BYTES / op_bytes)))
    mats = [D] + [type(D)(D.offsets, D.data.clone(), D.shape)
                  for _ in range(copies - 1)]
    f64 = D.data.dtype == torch.float64
    fns = {}
    for tag, dll in libs.items():
        if tag in F64_ONLY and not f64:
            continue
        y = matvec(torch, np, cuda, dll, D, x)
        rel = float((y - ref).norm() / ref.norm())
        if not rel <= tol:
            raise SystemExit(f"{tag} build disagrees with the plain version "
                             f"on {grid}^2 {name}: {rel:.3e}")
        fns[tag] = [lambda dll=dll, M=M: matvec(torch, np, cuda, dll, M,
                                                x) for M in mats]
    bound_ms = (op_bytes + (n_rows + n_cols) * T) / chip_smoke.HBM_BYTES_S \
        * 1e3
    zero_share = 1 - int(torch.count_nonzero(D.data)) / D.data.numel()
    for tag in fns:
        if tag == "as_is":
            continue
        t = [chip_smoke.graph_ms(torch, fns[k])
             for k in ("as_is", tag, tag, "as_is")]
        print(json.dumps({
            "grid": grid, "operator": name, "dtype": str(D.data.dtype),
            "n": n_rows, "K": len(D.offsets), "offsets": list(D.offsets),
            "zero_share": zero_share, "copies": copies, "variant": tag,
            "as_is_ms": min(t[0], t[3]), "variant_ms": min(t[1], t[2]),
            "bound_ms": bound_ms}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grids", default="512,2048",
                    help="comma-separated grid sides")
    ap.add_argument("--baseline", default=None,
                    help="another DIA kernel source with the same C "
                         "interface, timed as variant 'baseline'")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke
    import pflare_tpu_torch as tpf
    from pflare_tpu_torch import cuda
    from pflare_tpu_torch.sparse import DIA
    from pflare_tpu_torch.sparse import dia as tdia

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"# {smi.splitlines()[0]}")
    ptxas = cuda.build("dia_spmv", tag="as_is", flags=("-Xptxas", "-v"))[1]
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
    spills = [ln.strip() for ln in ptxas.splitlines()
              if re.search(r"[1-9]\d* bytes spill", ln)]
    if regs:  # else the library was up to date and not rebuilt
        print(f"# ptxas, as-is build: {len(regs)} kernels, registers "
              f"{min(regs)}..{max(regs)}, spill lines: {spills or 'none'}")
    text = open(os.path.join(cuda.CSRC, "dia_spmv.cu")).read()
    out_dir = os.path.join(cuda.BUILD_DIR, "dia_variants")
    os.makedirs(out_dir, exist_ok=True)
    srcs = {tag: variant_source(text, edits,
                                os.path.join(out_dir, f"dia_{tag}.cu"))
            for tag, edits in VARIANTS.items()}
    if args.baseline:
        srcs["baseline"] = os.path.abspath(args.baseline)
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        list(pool.map(lambda tag: cuda.build("dia_spmv", srcs[tag], tag),
                      srcs))  # one nvcc for each source, all together
    libs = {"as_is": cuda.load("dia_spmv", tag="as_is")}
    libs.update((tag, cuda.load("dia_spmv", src=src, tag=tag))
                for tag, src in srcs.items())

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    for grid in (int(g) for g in args.grids.split(",")):
        A = tpf.adv_diff_2d(grid)
        pc = tpf.PCAIR(chip_smoke.bench_options(tpf, max_levels=2),
                       dtype=torch.float32, device=dev)
        pc.setup(A.astype(np.float32))
        dh = pc.upload()
        ops = [("top A", dh.top),
               ("top A", DIA.from_scipy(A, dtype=torch.float64).to(dev))]
        ops += [(f"level 0 {k}", dh.levels[0][k])
                for k in ("A_ff", "A_fc", "R", "P")]
        for name, D in ops:
            if isinstance(D, DIA):
                compare(torch, np, cuda, tdia, chip_smoke, libs, rng, grid,
                        name, D)
        del pc, dh, ops
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
