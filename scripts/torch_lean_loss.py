#!/usr/bin/env python3
"""Whether the lean qwen3-0.6b arms of `chip_smoke.py` phase 3h lower their
loss, at a given step size and number of rounds, from the `src/` tree
given (so two trees' weight draws can be set side by side in one call):

    python scripts/torch_lean_loss.py src bf16:3.0:4 qsgd:3.0:6
    python scripts/torch_lean_loss.py build/parent/src bf16:3.0:4

Each ARM:LR:ROUNDS runs Fed-CHS on the card with 3h's task and knobs
(`chip_smoke.lm_task`, f32 master, `Precision()`, client_microbatch
LEAN_MB, remat, flash; "bf16" the bf16 dense wire, "qsgd" QSGD(16)
uplinks) and prints the recorded train loss of each round, the held-out
perplexity of each round, and `chip_smoke.first_batches_loss` before and
after the run.
"""
import dataclasses
import sys
import time
from pathlib import Path

sys.path[:0] = [sys.argv[1], str(Path(__file__).resolve().parents[1])]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.comm.channels import QSGDChannel  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs  # noqa: E402
from repro_torch.core.precision import Precision  # noqa: E402
from repro_torch.utils import resolve_device  # noqa: E402


def main() -> None:
    resolve_device("cuda")
    cfg = dataclasses.replace(get_config(cs.LM_ARCH), dtype="float32")
    for arm in sys.argv[2:]:
        name, lr, rounds = arm.split(":")
        task = cs.lm_task(cfg, remat=True, num_clients=cs.LM_CLIENTS, batch_size=cs.LM_BATCH,
                          seq_len=cs.LM_SEQ)
        conf = FedCHSConfig(rounds=int(rounds), local_steps=cs.LM_K, local_epochs=cs.LM_E,
                            eval_every=1, seed=0,
                            channel=None if name == "bf16" else QSGDChannel(16),
                            schedule=lambda k, lr=float(lr): lr,
                            client_microbatch=cs.LEAN_MB, precision=Precision())
        t0 = time.perf_counter()
        res = run_fed_chs(task, conf)
        before = cs.first_batches_loss(torch, task, task.init_params())
        after = cs.first_batches_loss(torch, task, res.final_params)
        print(f"{sys.argv[1]} {name} lr {lr} rounds {rounds}: train loss "
              f"{[round(x, 4) for x in res.train_loss]}, perplexity "
              f"{[round(x) for x in res.test_acc]}, loss on the first batches {before:.4f} -> "
              f"{after:.4f} ({time.perf_counter() - t0:.1f} s)", flush=True)
        del task, res
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
