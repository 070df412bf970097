"""Runs one cell of the benchmark once, on the machine it is started on:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json `workloads`) names a
configuration (`benchmark/configs/<config>.json`) and a traffic mix
(`benchmark/traffic/<traffic>.json`, whose `driver` is the general loop in
`benchmark/drivers/`). Set-up builds the inputs from the seed and warms
the cell's shapes; the window then runs for `--seconds`; after it the
timed path's outputs are held against the plain reference
(`benchmark/reference/`), and the numbers compared, each beside its limit
(the configuration's `limits`), decide `correct`.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (with `--trace 0` the cell's end-to-end
metrics, with `--trace 1` its per-layer ones, each read by
`benchmark/metrics/<name>.py`), `device`, with `--trace 1` `breakdown`,
and last `checks`. The numbers compared are also the last lines of
standard error.

Exits 2 without a result when CUDA is missing or has fewer cards than the
cell asks for, or when the program's package is absent; exits 3 without a
result when a module of JAX or of the JAX package was loaded. `--control
1` puts the control in the program's place for the check (not a run of
the benchmark: the limits' upper readings): the reference with float8
operands, one precision below the configuration's bfloat16 rule. Its
numbers are judged by the same limits and decide `correct`; the
program's own are printed before them on standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "deeppointmap_tpu")


def process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(float(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = process_start()


def _setup_env() -> None:
    """Caches inside the checkout, at fixed paths; no JAX through
    libraries that would load it."""
    cache = os.path.join(HERE, ".cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ.setdefault(var, os.path.join(cache, sub))
    # few host threads: the host layer's BLAS and OpenMP pools otherwise
    # take every core of a host that other tenants share
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "2")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    if REPO not in sys.path:
        sys.path.insert(0, REPO)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def judge(numbers: dict, limits: dict, reported=()) -> list:
    """[(name, value, limit, ok)] for every number but those `reported`
    (worked out and printed, not compared: the configuration's
    `reported`); any other number without a limit is a fault of the
    configuration."""
    out = []
    for name, value in numbers.items():
        if name in reported:
            continue
        if name not in limits:
            raise KeyError(f"no limit for the compared number {name!r}")
        limit = float(limits[name])
        out.append((name, float(value), limit, float(value) <= limit))
    return out


def main(argv=None, allow_cpu: bool = False, root: str = REPO,
         bench: str = HERE) -> int:
    """`allow_cpu`, `root` and `bench` serve the benchmark's own tests: a
    run on the CPU, of a BENCHMARK.json and configuration and traffic
    files elsewhere."""
    _setup_env()
    a = parse(argv)
    try:
        import deeppointmap_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program's package is not here: {e}", file=sys.stderr)
        return 2
    import torch

    from benchmark.lib import spec

    cell = spec.cell(a.workload, root, bench)
    if not allow_cpu and (not torch.cuda.is_available()
                          or torch.cuda.device_count() < cell.chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this "
              f"machine has {have}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        and not allow_cpu else torch.device("cpu")
    say = lambda msg: print(msg, file=sys.stderr, flush=True)
    controls = ("fp8",) if a.control else ()
    out = spec.driver(cell.traffic).run(cell, a.seed, a.seconds,
                                        bool(a.trace), device, controls,
                                        say=say)
    window_wall = time.time() - (time.perf_counter() - out["window_start"])
    limits = cell.config["limits"]
    reported = tuple(cell.config.get("reported", ()))
    checks = judge(out["numbers"], limits, reported)
    for prec, nums in out.get("controls", {}).items():
        # the control in the program's place: its numbers where it
        # recomputes them, the program's elsewhere, judged the same way
        for n, v, lim, ok in checks:
            say(f"program check {n}: {v!r} (limit {lim!r}) "
                f"{'ok' if ok else 'FAIL'}")
        say(f"program correct: {all(c[3] for c in checks)}")
        for n in reported:
            if n in nums:
                say(f"control {prec} reported {n}: {nums[n]!r}")
        checks = judge(dict(out["numbers"], **nums), limits, reported)
        say(f"control {prec} over its limits: "
            f"{[n for n, _, _, ok in checks if not ok]}")

    bad = loaded_forbidden()
    if bad:
        say(f"forbidden modules loaded: {bad}")
        return 3

    if a.trace:
        metrics = spec.read_per_layer(cell.per_layer, out["rec"], bench)
    else:
        values = dict(out["e2e"], setup_s=window_wall - T_START)
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise KeyError(f"{cell.name} reports no {m['name']}")
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(out["memory_peak"])}
    result = {"correct": all(c[3] for c in checks),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if a.trace:
        tr = out["trace"]
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim, _ in checks}
    for n in reported:
        if n in out["numbers"]:
            say(f"reported {n}: {out['numbers'][n]!r} (not compared)")
    for n, v, lim, ok in checks:
        say(f"check {n}: {v!r} (limit {lim!r}) {'ok' if ok else 'FAIL'}")
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
