"""Runs one cell of the benchmark once and prints its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  It loads the cell's configuration and
traffic, builds the serving stack on the card (set-up), serves the traffic
for ``--seconds`` (the window), checks what the window served against the
plain reference, and prints one JSON line as the last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
and, traced, ``breakdown``; the numbers compared, each beside its limit,
close standard error and the line (``checked``).

Exits 2, printing no result, without a card, with fewer cards than the
cell asks for, outside a checkout holding the program, or when JAX or the
JAX package was loaded.  ``--control`` (not used by the benchmark's own
runs) reads the check with the reference at the next precision down in the
program's place; ``--rate`` overrides an open loop's rate (the sweep).
"""
from __future__ import annotations

import time

T_PROC = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--rate", type=float, default=None)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    # one host thread for the CPU side: the program's hot path is its launch
    # loop, which idle OpenMP workers spinning beside it only slow
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    if not (ROOT / "BENCHMARK.json").is_file() or not (ROOT / "src" / "repro_torch").is_dir():
        print("run from the root of a checkout that holds BENCHMARK.json and src/repro_torch",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    torch.set_num_threads(1)
    from portbench import harness
    spec = harness.load_spec(ROOT)
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, err, mods = harness.run(ROOT, args.workload, args.seed, args.seconds,
                                    bool(args.trace), device="cuda", t_proc=T_PROC,
                                    control=args.control, rate=args.rate)
    if mods:
        print(f"modules of the JAX side were loaded: {mods}", file=sys.stderr)
        return 2
    for line in err:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
