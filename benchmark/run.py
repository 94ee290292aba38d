"""Benchmark of ``warpconvnet_tpu_torch`` on one NVIDIA H100 (sm_90).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` in this process: builds the model and
the cell's traffic pool from the seed on the card, warms up, measures for
``--seconds``, checks the timed path's answers against the plain reference
and prints one JSON object as the last line of standard output: the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics (and a
breakdown of the profiled slice) with ``--trace 1``. The numbers compared
are printed beside their limits as the last lines of standard error and
under ``checks``, the last key of the result. Exits non-zero, with no
result, without a card of compute capability 9.0 or more, and where JAX,
jaxlib, flax or the JAX package ``warpconvnet_tpu`` was loaded into this
process by the time the run ends.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
JAX_TOPS = ("jax", "jaxlib", "flax", "warpconvnet_tpu")


def jax_modules(modules) -> list:
    """Names in ``modules`` whose top-level name is one of ``JAX_TOPS``,
    compared whole (``warpconvnet_tpu_torch`` is the port)."""
    return sorted(m for m in modules if m.split(".")[0] in JAX_TOPS)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # Kernel caches at fixed paths inside the checkout, so that only a
    # checkout's first run builds.
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "_cache", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, "_cache", "torch_extensions")
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from benchmark.harness import cell, spec

    chips = spec.cell(args.workload).chips
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    if torch.cuda.get_device_capability() < (9, 0):
        print(f"{torch.cuda.get_device_name()} is not sm_90", file=sys.stderr)
        return 2
    from benchmark.harness import measure

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {measure.card_name()}; clocks.sm, power.draw, temperature: "
          f"{measure.card_state()}", file=sys.stderr, flush=True)
    out = cell.execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    loaded = jax_modules(sys.modules)
    if loaded:
        print("loaded in the measured process: " + ", ".join(loaded), file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
