#!/usr/bin/env python3
"""Where the port's slowest tests spend their time, test by test.

    python scripts/torch_test_profile.py --junit /tmp/_t1.xml --top 15 \
        [--root DIR] [--out FILE]

Takes the `--top` slowest `tests/test_torch_*.py` cases of a junit XML (the
test command writes one with `--junitxml`) and runs each alone, in a fresh
interpreter from the checkout `--root` (default: this one), under cProfile.
Each test's wall seconds are split into:

* `jax_compile`: JAX's lowering to HLO and XLA's compile (cumulative time of
  `pxla._cached_lowering_to_hlo` and `compiler.compile_or_get_cached`);
* `torch_ops`: the self time of torch's builtins (its operations, their
  waits on torch's own threads included);
* `draw`: the port's plain weight draw, `kernels/ref.py::normal_ref`;
* `subprocess`: waits on the processes the test starts (`subprocess` and
  `multiprocessing`), and `startup`, the part of it estimated as their count
  times one bare interpreter start that imports torch and `repro_torch`;
* `lock_waits`: the self time of thread-lock acquires (idle waits on other
  threads);
* `collect`: pytest's collection of the test, run once before the profiled
  run: the imports of torch, JAX, both packages and the test module;
* `other`: the rest (Python: JAX tracing and eager dispatch, numpy, the
  reference's interpret-mode kernels, pytest).

A test alone on an idle machine shows its work, not what the parallel run's
contention adds to it.  One JSON line per test goes to `--out` (and stdout),
then a table.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from pathlib import Path

_HERE = Path(__file__).resolve()


def slowest(junit: str, top: int) -> list[tuple[str, float]]:
    """The `top` slowest port test cases of a junit XML, as (node id, s)."""
    rows = []
    for case in ET.parse(junit).iter("testcase"):
        parts = case.get("classname", "").split(".")
        mod = next((i for i, p in enumerate(parts) if p.startswith("test_")), None)
        if mod is None or not parts[mod].startswith("test_torch_"):
            continue
        node = ("/".join(parts[:mod + 1]) + ".py::"
                + "::".join(parts[mod + 1:] + [case.get("name")]))
        rows.append((node, float(case.get("time", 0))))
    return sorted(rows, key=lambda r: -r[1])[:top]


def _outer_cumtime(stats: dict, where: str, names: tuple[str, ...]) -> tuple[float, int]:
    """Cumulative seconds of the functions `names` of files matching `where`,
    counted only from callers outside those files, and their call count."""
    secs, calls = 0.0, 0
    for (path, _, name), (_, nc, _, _, callers) in stats.items():
        if where in path and name in names:
            calls += nc
            secs += sum(ct for (cpath, _, _), (_, _, _, ct) in callers.items()
                        if where not in cpath)
    return secs, calls


def split(stats: dict, wall: float) -> dict:
    def cum(where, name):
        return sum(v[3] for k, v in stats.items() if where in k[0] and k[2] == name)

    out = {"wall": wall,
           "jax_compile": cum("interpreters/pxla.py", "_cached_lowering_to_hlo")
           + cum("jax/_src/compiler.py", "compile_or_get_cached"),
           "torch_ops": sum(v[2] for k, v in stats.items()
                            if k[0] == "~" and "torch" in k[2] and "acquire" not in k[2]),
           "draw": cum("kernels/ref.py", "normal_ref"),
           "lock_waits": sum(v[2] for k, v in stats.items()
                             if k[0] == "~" and "acquire" in k[2] and "lock" in k[2])}
    sub, _ = _outer_cumtime(stats, "subprocess.py", ("run", "communicate", "wait"))
    mp, _ = _outer_cumtime(stats, "multiprocessing", ("join", "get", "recv", "wait"))
    _, n_popen = _outer_cumtime(stats, "subprocess.py", ("__init__",))
    _, n_mp = _outer_cumtime(stats, "multiprocessing/process.py", ("start",))
    out["subprocess"], out["n_processes"] = sub + mp, n_popen + n_mp
    out["other"] = wall - sum(out[k] for k in ("jax_compile", "torch_ops", "draw", "lock_waits",
                                               "subprocess"))
    return out


def run_one(node: str) -> None:
    import pytest

    args = [node, "-q", "-p", "no:cacheprovider", "-p", "no:randomly"]
    t0 = time.perf_counter()
    pytest.main(args + ["--collect-only"])
    collect = time.perf_counter() - t0
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    rc = pytest.main(args)
    prof.disable()
    wall = time.perf_counter() - t0
    row = split(pstats.Stats(prof).stats, wall)
    row.update(node=node, rc=int(rc), collect=collect)
    print("PROFILE " + json.dumps(row))


def startup_seconds(root: Path, env: dict) -> float:
    """The best of three bare interpreter starts that import torch and
    repro_torch."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", "import torch, repro_torch"], cwd=root, env=env,
                       check=True)
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--junit")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--root", default=str(_HERE.parents[1]))
    ap.add_argument("--out")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        return run_one(args.one)
    root = Path(args.root).resolve()
    env = dict(os.environ, PYTHONPATH=str(root / "src"), JAX_PLATFORMS="cpu")
    start = startup_seconds(root, env)
    print(f"bare start (import torch, repro_torch): {start:.2f} s; {os.cpu_count()} cores")
    rows = []
    for node, junit_s in slowest(args.junit, args.top):
        proc = subprocess.run([sys.executable, str(_HERE), "--one", node], cwd=root, env=env,
                              capture_output=True, text=True)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("PROFILE ")]
        if not line:
            print(f"{node}: no profile (exit {proc.returncode})\n{proc.stdout[-2000:]}")
            continue
        row = json.loads(line[-1][len("PROFILE "):])
        row.update(junit_s=junit_s, startup=min(row["subprocess"], row["n_processes"] * start))
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    keys = ("wall", "jax_compile", "torch_ops", "draw", "subprocess", "startup", "lock_waits",
            "collect", "other")
    print("| test | junit s | " + " | ".join(keys) + " |")
    print("| --- " * (len(keys) + 2) + "|")
    for r in rows:
        print(f"| `{r['node'].split('/')[-1]}` | {r['junit_s']:.0f} | "
              + " | ".join(f"{r[k]:.1f}" for k in keys) + " |")


if __name__ == "__main__":
    main()
