#!/usr/bin/env python3
"""Phase 3e's first arm alone, repeated, from one tree: its s/round apart
from what `chip_smoke.py` runs before it.  Run it once per tree in one call
on the card, alternating, to compare two trees:

    python scripts/torch_arm_ab.py build/parent parent
    python scripts/torch_arm_ab.py . change

Imports `chip_smoke.py` and `repro_torch` of the tree ROOT, builds its
kernels, prints the rate of the CPU's plain weight draw (`normal_ref`,
2^22 entries, twice, at torch's thread count), the seconds of 3a's LeNet
task with its host-drawn init (then the init again), and five runs of 3e's
Fed-CHS QSGD(16) arm (2 rounds, K = 20, E = 5, the paper's step) through
`comparison_arm`, each its s/round.
"""
import sys
import time
from pathlib import Path


def main() -> None:
    root, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    import chip_smoke as cs
    from repro_torch.comm.channels import QSGDChannel
    from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
    from repro_torch.kernels import build, ref
    from repro_torch.utils import resolve_device

    resolve_device("cuda")
    build.build()
    n = 1 << 22
    rates = []
    for _ in range(2):
        t0 = time.perf_counter()
        ref.normal_ref((7, 9), 12345, n, 0.02)
        rates.append(n / (time.perf_counter() - t0) / 1e6)
    t0 = time.perf_counter()
    task = cs.lenet_appendix_task(torch)
    task.init_params()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    task.init_params()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    cfg = FedCHSConfig(rounds=2, local_steps=cs.MAIN_K, local_epochs=cs.MAIN_E, eval_every=1,
                       channel=QSGDChannel(16), seed=0, schedule=cs.paper_schedule())
    arms = [cs.comparison_arm(torch, build, "Fed-CHS QSGD(16)",
                              lambda: run_fed_chs(task, cfg), 2)["s_per_round"]
            for _ in range(5)]
    print(f"{label}: normal_ref {rates[0]:.1f}M, {rates[1]:.1f}M entries/s at "
          f"{torch.get_num_threads()} threads; LeNet task + init {cold:.3f} s, init again "
          f"{warm:.3f} s; 3e first arm x5 s/round " + " ".join(f"{a:.3f}" for a in arms),
          flush=True)


if __name__ == "__main__":
    main()
