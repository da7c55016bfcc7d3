"""Run every JAX example of ``examples/`` on the CPU and record the figures
it prints, for ``scripts/torch_examples_sweep.py`` to hold the port's
examples against.

Each script runs in its own subprocess with ``MCMC_EXAMPLES_CPU=1`` (which
``examples/_common.py`` reads: JAX on the CPU, 8 virtual devices) under a
time limit of ``--timeout`` seconds (default 900). Every printed line is
parsed into ``label -> [numbers]``: the label is the text before the line's
first colon (else its leading words), the numbers every decimal in the rest;
a label seen again gets ``#2``, ``#3``. The result, with each script's
status, seconds and last lines of output, is written to
``examples_torch/jax_cpu_figures.json``. A script that runs past the limit
is recorded with its status ``timeout`` and the seconds it had run. From the
repository root, with JAX:

    python3 scripts/jax_examples_figures.py [--jobs 2] [--only name ...]
"""

import argparse
import concurrent.futures as cf
import json
import os
import platform
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
OUT = ROOT / "examples_torch" / "jax_cpu_figures.json"
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|nan|inf")
LEAD = re.compile(r"^[^\d\-+\[(]+")


def parse_figures(text):
    """``label -> [numbers]`` for every printed line that holds a number."""
    figures = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if ":" in line:
            label, rest = line.split(":", 1)
        else:
            m = LEAD.match(line)
            label = m.group(0) if m else ""
            rest = line[len(label):]
        label = " ".join(label.split())
        nums = [float(v) for v in NUMBER.findall(rest)]
        if not nums:
            continue
        key, k = label, 2
        while key in figures:
            key, k = f"{label}#{k}", k + 1
        figures[key] = nums
    return figures


def run_one(name, timeout):
    env = dict(os.environ, MCMC_EXAMPLES_CPU="1", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    try:
        p = subprocess.run([sys.executable, f"{name}.py"], cwd=EXAMPLES,
                           env=env, capture_output=True, text=True,
                           timeout=timeout)
        status = "ok" if p.returncode == 0 else f"rc {p.returncode}"
        out, err = p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        status = "timeout"
        out = e.stdout.decode() if isinstance(e.stdout, bytes) else \
            (e.stdout or "")
        err = e.stderr.decode() if isinstance(e.stderr, bytes) else \
            (e.stderr or "")
    seconds = time.perf_counter() - t0
    rec = {"status": status, "seconds": round(seconds, 1),
           "figures": parse_figures(out),
           "stdout_tail": out.splitlines()[-30:]}
    if status != "ok":
        rec["stderr_tail"] = err.splitlines()[-20:]
    return name, rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--only", nargs="*")
    args = ap.parse_args()
    names = sorted(p.stem for p in EXAMPLES.glob("*.py")
                   if not p.name.startswith("_"))
    if args.only:
        names = [n for n in names if n in args.only]
    old = json.loads(OUT.read_text()) if OUT.exists() else {}
    results = dict(old.get("examples", {}))
    with cf.ThreadPoolExecutor(args.jobs) as pool:
        for name, rec in pool.map(lambda n: run_one(n, args.timeout), names):
            results[name] = rec
            print(json.dumps({"example": name, "status": rec["status"],
                              "seconds": rec["seconds"]}), flush=True)
            OUT.parent.mkdir(exist_ok=True)
            OUT.write_text(json.dumps({
                "host": {"machine": platform.machine(),
                         "cpus": os.cpu_count(),
                         "python": platform.python_version()},
                "jobs": args.jobs, "timeout_s": args.timeout,
                "examples": dict(sorted(results.items()))}, indent=1) + "\n")
    bad = [n for n in names if results[n]["status"] != "ok"]
    print(json.dumps({"ran": len(names), "not_ok": bad}))


if __name__ == "__main__":
    main()
