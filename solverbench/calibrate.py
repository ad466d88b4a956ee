"""The readings that the limits of ``checks/<workload>.json`` are set from.

    python3 solverbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --seconds <s> --control-seeds 7,8,9 [--out <file.json>]

On the card, in one process: the cell is set up once; for each of
``--seeds`` a window of ``--seconds`` at the cell's own load, its sample
judged by the reference as a run judges it (the program's readings, whose
largest is the lower reading); then the control on each of
``--control-seeds``: the exact solution of A x = b (x drawn from the seed,
b = A x) rounded to TF32 and to bfloat16, judged the same way, on the
cell's operator.  Prints one JSON line a reading and writes them all to
``--out``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from solverbench import harness, reference

    from pflare_tpu_torch import cuda

    cuda.build_all()
    spec = harness.load_spec(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = []

    def emit(row):
        print(json.dumps(row), flush=True)
        out.append(row)

    t0 = time.perf_counter()
    cell = harness.Cell(spec, seeds[0], "cuda", harness.OPERATOR_CACHE)
    for _ in range(spec["traffic"]["warm_requests"]):
        cell.request()
    emit({"setup_s": time.perf_counter() - t0})
    for seed in seeds:
        cell.reseed(seed)
        recs, window_s = cell.window(args.seconds, instrument=False)
        answers = [(x.double().cpu().numpy(), b.double().cpu().numpy())
                   for x, b in cell.sample.items]
        failed = sum(not r["converged"] for r in recs)
        checks = harness.judge(spec["checks"], cell.A, answers, failed)
        emit({"program": seed, "requests": len(recs),
              "window_s": window_s, "judged": len(answers),
              "its": sorted({r["its"] for r in recs}), "unconverged": failed,
              "max_rel_residual": checks["max_rel_residual"]["value"]})
        del answers
        torch.cuda.empty_cache()
    A = cell.A
    del cell
    for seed in (int(s) for s in args.control_seeds.split(",")):
        for precision in ("tf32", "bfloat16"):
            emit({"control": seed, "precision": precision,
                  "max_rel_residual": reference.control_residual(
                      A, seed, precision)})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
