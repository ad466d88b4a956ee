"""Run one cell of the benchmark once, on the card.

    python3 solverbench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout that holds ``pflare_tpu_torch``.  The run sets
up the cell (see ``harness.py``), measures for ``--seconds``, has the
reference judge a sample of the window's answers, and prints one JSON
line last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each number compared with its limit, which also end standard
error.  Without a card, with fewer cards than the cell asks for, without
the program, or with JAX loaded, it exits with another code than 0 and
prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def checkout_env():
    """Caches inside the checkout, at fixed paths (the kernel caches here,
    the operators in ``harness.OPERATOR_CACHE``); no eager-solver switch
    from the caller's environment."""
    cache = os.path.join(ROOT, "solverbench", "_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ.pop("PFLARE_EAGER_KSP", None)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def fail(msg: str) -> int:
    print(f"solverbench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    checkout_env()

    from solverbench import harness

    spec = harness.load_spec(args.workload)
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if torch.cuda.device_count() < spec["chips"]:
        return fail(f"{torch.cuda.device_count()} CUDA devices, the cell "
                    f"asks for {spec['chips']}")
    try:
        import pflare_tpu_torch
    except ImportError as e:
        return fail(f"the program is not in this checkout: {e}")
    where = os.path.dirname(os.path.abspath(pflare_tpu_torch.__file__))
    if where != os.path.join(ROOT, "pflare_tpu_torch"):
        return fail(f"pflare_tpu_torch loaded from {where}, not from the "
                    "checkout")
    from pflare_tpu_torch import cuda

    cuda.build_all()
    result = harness.run_cell(spec, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START,
                              cache=harness.OPERATOR_CACHE)
    bad = harness.forbidden_modules()
    if bad:
        return fail(f"modules the run may not load are loaded: {bad}")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
