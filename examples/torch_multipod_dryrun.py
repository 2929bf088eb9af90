"""Launcher API tour (the port's twin of examples/multipod_dryrun.py): lower
one architecture onto the 2-pod production mesh (2 x 16 x 16, a fake world
of 512 ranks in this process; no card needed) with the Fed-CHS
pod-sequential variant and the HFL baseline, and print each one's roofline
terms on H100 and the collective bytes between them: the pass is a pod-axis
permutation, the HFL mean an all-reduce over the pods.

  PYTHONPATH=src python examples/torch_multipod_dryrun.py --arch qwen3-0.6b
"""
import argparse

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch.mesh import MULTI_POD_CHIPS, fake_world, make_production_mesh
from repro_torch.launch.steps import build_lowering, lower_spec
from repro_torch.roofline import analyze_trace, roofline_terms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list(ARCH_IDS))
    args = ap.parse_args()

    cfg = get_config(args.arch)
    results = {}
    with fake_world(MULTI_POD_CHIPS):
        mesh = make_production_mesh(multi_pod=True, device="cpu")
        print(f"mesh: {mesh.shape} = {mesh.size} ranks (fake)")
        for variant in ("fedchs", "hfl"):
            rec = analyze_trace(lower_spec(build_lowering(cfg, "train_4k", mesh,
                                                          variant=variant), mesh))
            terms = roofline_terms(rec)
            results[variant] = rec
            print(f"\n[{variant}] bound={terms['bound']}  "
                  f"compute={terms['compute_s']:.3e}s memory={terms['memory_s']:.3e}s "
                  f"collective={terms['collective_s']:.3e}s")
            for op, b in sorted(rec["collectives"].items()):
                print(f"   {op:20s} {b / 1e9:10.3f} GB/device")

    saved = (results["hfl"]["collective_bytes_per_device"]
             - results["fedchs"]["collective_bytes_per_device"])
    print(f"\nFed-CHS moves {saved / 1e9:.3f} GB/device less collective traffic per round "
          "than star-aggregated HFL (the paper's §5.3 claim, in the port's counted trace).")


if __name__ == "__main__":
    main()
