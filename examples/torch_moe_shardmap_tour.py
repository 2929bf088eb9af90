"""Tour of the MoE optimization stack (the port's twin of
examples/moe_shardmap_tour.py).

Lowers an MoE arch x train_4k on the 256-rank production mesh (a fake world
in this process; no card needed) twice:
  * the paper-faithful baseline: global expert-choice routing, DTensor's
    sharding propagation decides every collective;
  * the --opt configuration: group-limited routing and the MoE interior
    with its collectives written out (models/moe_shardmap.py), whose only
    forward communication is a per-layer (n_loc, d) sum over "model";
and prints the roofline terms on H100 and the top collective sources of each.

  PYTHONPATH=src python examples/torch_moe_shardmap_tour.py [--arch deepseek-v3-671b]
"""
import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dbrx-132b", choices=["deepseek-v3-671b", "dbrx-132b"])
    args = ap.parse_args()

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import POD_CHIPS, fake_world, make_production_mesh
    from repro_torch.launch.steps import build_lowering, lower_spec
    from repro_torch.roofline import analyze_trace, roofline_terms
    from repro_torch.roofline.attribution import collective_breakdown

    cfg = get_config(args.arch)
    results = {}
    with fake_world(POD_CHIPS):
        mesh = make_production_mesh(device="cpu")
        for name, optimized in (("baseline", False), ("+opt(local_map)", True)):
            trace = lower_spec(build_lowering(cfg, "train_4k", mesh, optimized=optimized), mesh)
            rec = analyze_trace(trace)
            terms = roofline_terms(rec)
            results[name] = rec
            print(f"\n[{name}] bound={terms['bound']}  "
                  f"compute={terms['compute_s']:.1f}s memory={terms['memory_s']:.1f}s "
                  f"collective={terms['collective_s']:.1f}s")
            for row in collective_breakdown(trace, top=3):
                print(f"   {row['bytes'] / 1e9:8.1f} GB/dev  {row['op']:18s} "
                      f"{row['shape'][:40]:40s} <- ...{row['source'][-45:]}")

    ratio = (results["baseline"]["collective_bytes_per_device"]
             / max(results["+opt(local_map)"]["collective_bytes_per_device"], 1))
    print(f"\nThe optimized interior moves {ratio:.1f}x fewer collective bytes per step.")


if __name__ == "__main__":
    main()
