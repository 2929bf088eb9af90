#!/usr/bin/env python3
"""Seconds that `init_params` takes on the card for the full-width configs
that `chip_smoke.py` draws (its `INIT_CONFIGS`: phase 3b's qwen3-0.6b in
f32, and phases 3k-3m's cuts), from the `src/` tree given, so that two trees can be timed
in one call on the same card:

    python scripts/torch_init_seconds.py --src build/parent/src --label parent
    python scripts/torch_init_seconds.py --src src --label change

With `--smoke --device cpu`, the registry's smoke configs on the CPU (what
the tests draw), with the entries a second, and first the rate of the plain
draw `kernels/ref.py::normal_ref` alone over 2^22 entries (f32 and bf16, the
best of three draws); run it under `OMP_NUM_THREADS=1` for one torch thread.

Each config is drawn twice (the first draw builds and loads the kernels)
and the second draw's wall seconds, ended by a synchronize, are printed,
then one JSON line {label: {config: seconds}}.  Before the PRNG kernel the
port drew its weights with `torch.randn` on a `torch.Generator`; after it,
with the reference's threefry draw (`kernels/normal.py`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="the smoke configs of the registry")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(Path(args.src).resolve()), str(Path(__file__).resolve().parents[1])]
    import torch

    from chip_smoke import INIT_CONFIGS
    from repro_torch.configs.registry import ARCH_IDS, get_config, smoke_config
    from repro_torch.models import transformer as tf
    from repro_torch.utils import tree_num_params

    on_card = args.device != "cpu"
    if on_card:
        if not torch.cuda.is_available():
            raise SystemExit("needs a CUDA card")
        where = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=60).stdout.strip()
    else:
        where = f"the CPU, {torch.get_num_threads()} torch threads"
    print(f"{args.label}: {Path(args.src).resolve()} on {where}")
    configs = [("smoke", arch, smoke_config(arch)) for arch in ARCH_IDS] if args.smoke else \
        [(phase, arch, dataclasses.replace(get_config(arch), **kw))
         for phase, arch, kw in INIT_CONFIGS]
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = {}
    if not on_card:
        from repro_torch.kernels.ref import normal_ref

        n = 1 << 22
        for dtype in (torch.float32, torch.bfloat16):
            secs = min(_seconds(lambda: normal_ref((7, 9), 12345, n, 0.02, dtype))
                       for _ in range(3))
            out[f"normal_ref {dtype}"] = secs
            print(f"  normal_ref: {n} entries ({dtype}) in {secs:.3f} s "
                  f"({n / secs / 1e6:.1f}M a second)")
    for phase, arch, cfg in configs:
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            params = tf.init_params(cfg, 0, args.device)
            sync()
            secs = time.perf_counter() - t0
            n = tree_num_params(params)
            del params
            if on_card:
                torch.cuda.empty_cache()
        out[f"{phase} {arch}"] = secs
        print(f"  {phase} {arch} ({cfg.num_layers} layers, {cfg.dtype}): {n} params drawn in "
              f"{secs:.3f} s ({n / secs / 1e6:.1f}M a second)")
    print(json.dumps({args.label: out}))


def _seconds(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


if __name__ == "__main__":
    main()
