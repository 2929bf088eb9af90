"""The multi-pod dry run (port of `repro/launch/dryrun.py`): lower every
(architecture x input shape) onto the production meshes and record the
per-device FLOPs, bytes, collectives and peak memory, priced on `H100`.

It needs no card and no cluster: each lowering runs the step once on fake
tensors (`FakeTensorMode`) laid out as DTensors on a fake process group of
256 or 512 ranks (`launch.mesh.fake_world`), under the roofline's counting
mode (`launch.steps.lower_spec`, `roofline.analyze_trace`).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # full 2-mesh sweep
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single --variant fedchs

Records land in experiments/dryrun_torch/<arch>__<shape>__<mesh>__<variant>.json.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs.registry import ARCH_IDS, get_config, long_context_config
from repro_torch.launch.mesh import MULTI_POD_CHIPS, POD_CHIPS, fake_world, make_production_mesh
from repro_torch.launch.steps import SHAPES, build_lowering, lower_spec
from repro_torch.roofline.analysis import analyze_trace, model_flops, roofline_terms

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                       "dryrun_torch")


def shape_supported(arch: str, shape: str) -> bool:
    cfg = get_config(arch)
    if shape == "long_500k":
        return cfg.long_context_ok
    return True


def config_for(arch: str, shape: str):
    if shape == "long_500k":
        return long_context_config(arch)
    return get_config(arch)


def run_one(arch: str, shape: str, mesh_kind: str, variant: str, *,
            out_dir: str = OUT_DIR, verbose: bool = True, optimized: bool = False) -> dict:
    """Lower one (arch, shape) on the single- or multi-pod mesh, inside a
    fake world of its size, and write its record."""
    cfg = config_for(arch, shape)
    multi = mesh_kind == "multi"
    with fake_world(MULTI_POD_CHIPS if multi else POD_CHIPS):
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        n_chips = mesh.size
        t0 = time.time()
        spec = build_lowering(cfg, shape, mesh, variant=variant, optimized=optimized)
        trace = lower_spec(spec, mesh)
        t_lower = time.time() - t0

    record = analyze_trace(trace)
    if optimized:
        variant = variant + "+opt" if SHAPES[shape]["mode"] == "train" else "opt"
    info = SHAPES[shape]
    tokens = info["global_batch"] * (info["seq_len"] if info["mode"] != "decode" else 1)
    kind = "train" if info["mode"] == "train" else "serve"
    n_params = cfg.active_param_count() if cfg.is_moe else cfg.param_count()
    mf = model_flops(n_params, tokens, kind=kind)
    terms = roofline_terms(record)
    total_dev_flops = record["dot_flops_per_device"] * n_chips
    result = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_kind,
        "chips": int(n_chips),
        "variant": variant if (info["mode"] == "train" or optimized) else "-",
        "mode": info["mode"],
        "seq_len": info["seq_len"],
        "global_batch": info["global_batch"],
        "params": int(cfg.param_count()),
        "active_params": int(n_params),
        "model_flops": mf,
        "model_vs_hlo": mf / total_dev_flops if total_dev_flops else None,
        "lower_s": round(t_lower, 2),
        "compile_s": 0.0,  # nothing is compiled: the lowering is the counted run
        "hw": "H100",
        **record,
        **terms,
    }
    os.makedirs(out_dir, exist_ok=True)
    fn = os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}__{variant}.json")
    with open(fn, "w") as f:
        json.dump(result, f, indent=1, default=str)
    if verbose:
        print(f"OK  {arch:20s} {shape:12s} {mesh_kind:6s} {variant:7s} "
              f"lower={t_lower:6.1f}s bound={terms['bound']:10s} "
              f"comp={terms['compute_s']:.3e}s mem={terms['memory_s']:.3e}s "
              f"coll={terms['collective_s']:.3e}s "
              f"mem/dev={record['memory'].get('peak_bytes', 0) / 1e9:.2f}GB", flush=True)
    return result


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default=None, choices=["single", "multi"])
    ap.add_argument("--variant", default="fedchs", choices=["fedchs", "hfl"])
    ap.add_argument("--opt", action="store_true",
                    help="apply the beyond-paper perf config (remat policy, MoE interior, pure DP)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]

    failures = []
    for arch in archs:
        for shape in shapes:
            if not shape_supported(arch, shape):
                print(f"SKIP {arch} {shape} (full-attention arch)")
                continue
            for mesh_kind in meshes:
                try:
                    run_one(arch, shape, mesh_kind, args.variant, out_dir=args.out,
                            optimized=args.opt)
                except Exception as e:  # noqa: BLE001 — reported, and the run exits 1
                    failures.append((arch, shape, mesh_kind, repr(e)))
                    print(f"FAIL {arch} {shape} {mesh_kind}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES")
        raise SystemExit(1)
    print("\nAll dry-runs passed.")


if __name__ == "__main__":
    main()
