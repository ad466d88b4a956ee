#!/usr/bin/env python3
"""The row mesh over several cards: ``chip_smoke.py``'s phase 15 (d)
alone, on the inputs the smoke builds for it (phase 7's 2048^2 f32
hierarchy and its matrix, the 512^2 main-path matrix), then a probe of
whether a PyTorch CUDA graph captures work on two cards.

    python3 tools/torch_mesh_cards.py [--out mesh_cards.json]

Runs on a machine with two or more cards (with one, phase 15 (d) prints
that it did not run).  Prints the cards (nvidia-smi), phase 15 (d)'s
lines, the probe's outcome and, last, one JSON line of the numbers,
also written to ``--out`` where given.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def capture_probe(torch):
    """Capture, on card 0, work that also runs on card 1 (a peer copy, an
    add there, a copy back), in two ways: with card 1's work on its
    current stream, and on a stream of card 1 forked into the capture by
    an event; replay each and compare with the eager result."""
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    a = torch.randn(1 << 20, device=d0)
    b = torch.randn(1 << 20, device=d1)

    def plain():
        return ((a * 2).to(d1) + b).to(d0) * 3

    def forked():
        y = (a * 2).to(d1)
        s1 = torch.cuda.Stream(d1)
        s1.wait_stream(torch.cuda.current_stream(d0))
        with torch.cuda.stream(s1):
            z = y + b
        torch.cuda.current_stream(d0).wait_stream(s1)
        return z.to(d0) * 3

    ref = plain()
    torch.cuda.synchronize()
    out = {}
    for name, fn in (("current stream", plain), ("forked stream", forked)):
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(d0)
        side.wait_stream(torch.cuda.current_stream(d0))
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    got = fn()
                finally:
                    graph.capture_end()
            graph.replay()
            torch.cuda.synchronize()
            out[name] = ("captured; replay equals eager: "
                         f"{bool(torch.equal(got, ref))}")
        except Exception as exc:   # the probe reports any failure
            out[name] = f"failed: {type(exc).__name__}: {exc}"[:400]
            try:
                torch.cuda.synchronize()
            except Exception as exc2:
                out[name] += f"; then synchronize: {exc2}"[:200]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="a JSON file for the numbers")
    args = ap.parse_args()
    import numpy as np
    import torch

    import pflare_tpu_torch as tpf
    from pflare_tpu_torch import cuda
    from pflare_tpu_torch.sparse import banded as tbanded
    from pflare_tpu_torch.sparse import dia as tdia

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for cmd in (["nvidia-smi", "-L"],
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]):
        print(subprocess.run(cmd, capture_output=True, text=True).stdout,
              end="", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"# kernels built in {cuda.build_all():.3f} s", flush=True)
    dev = torch.device("cuda", 0)
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    A512 = tpf.adv_diff_2d(512)
    A2k = tpf.adv_diff_2d(2048)
    pc2k = tpf.PCAIR(smoke.bench_options(tpf, max_levels=10),
                     dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    pc2k.setup(A2k.astype(np.float32))
    pc2k.upload()
    torch.cuda.synchronize()
    print(f"# 2048^2 f32 setup and upload {time.perf_counter() - t0:.3f} s",
          flush=True)
    b2k = np.random.default_rng(1).standard_normal(A2k.shape[0])
    out = smoke.phase15d(np, torch, tpf, tdia, tbanded, dev, cards, A512,
                         pc2k, A2k, b2k)
    if len(cards) >= 2:
        out = dict(out or {}, capture_probe=capture_probe(torch))
        print(f"# capture probe: {out['capture_probe']}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
