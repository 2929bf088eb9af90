#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit, no result line):
  1. build the QSGD kernels from src/repro_torch/csrc with nvcc for sm_90a;
  2. hold each kernel against its plain torch version on the card: bit for
     bit on dyadic inputs (entries k * 2^-8, |k| <= 64, whose block norms
     are exact in any summation order); on Gaussian inputs norms at rtol
     1e-6 and codes within 1 at no more than 0.1% of entries;
  3. the main path, through the entry points a user calls: Fed-CHS with
     QSGD(16) uplinks on LeNet-MNIST at the paper's Appendix-A width, full
     synthetic MNIST, 100 clients / 10 ESs, Dirichlet 0.6, batch 32, K=20,
     E=5, a few rounds.  Every uplink must go through both kernels (launch
     counts), the ledger must price each uplink at the closed form, and the
     accuracy must end above chance; 2 more rounds run under the profiler,
     then again without it, and must repeat bit for bit.
     Then the quickstart MLP grad-mode config, and a small QSGD run on the
     card held against the same run on the CPU's plain path;
  4. time each kernel at the main path's shapes with CUDA events (L2 flushed
     before every launch), beside its plain version and its bound.
The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}.  Needs a CUDA device; exits non-zero without
one, and outside a checkout of the repository.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

LEVELS = (1, 3, 7, 15, 16, 127)
BLOCKS = (128, 1024)
NBS = (1, 7, 6272)
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
MAIN_ROUNDS, MAIN_K, MAIN_E = 6, 20, 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def dyadic(torch, gen, shape, device):
    return torch.randint(-64, 65, shape, generator=gen).to(torch.float32).mul(2.0**-8).to(device)


def lenet_leaf_blocks() -> list[int]:
    """Blocks per leaf of the main path's message (LeNet-MNIST, block 1024)."""
    from repro_torch.models.classifier import make_classifier
    from repro_torch.utils import tree_leaves

    params = make_classifier("lenet", "mnist", (28, 28, 1), 10).init(0, "cpu")
    return [math.ceil(leaf.numel() / 1024) for leaf in tree_leaves(params)]


def kernel_vs_plain(torch, qsgd, ref):
    """Phase 2. Returns the largest |kernel - plain| of each kernel's output.
    Cases: every (s, block, nb) of the grid with 2 senders, and every leaf of
    the main path's message with its 10 senders at s=16, block=1024."""
    gen = torch.Generator().manual_seed(0)
    err = {"qsgd_quantize_pack": 0.0, "qsgd_unpack_dequantize": 0.0}
    n_cases = 0
    grid = [(s, block, nb, 2) for s in LEVELS for block in BLOCKS for nb in NBS]
    grid += [(16, 1024, nb, 10) for nb in lenet_leaf_blocks()]
    for s, block, nb, senders in grid:
        bits = ref.qsgd_code_bits(s)
        for kind in ("dyadic", "gaussian"):
            shape = (senders, nb, block)
            if kind == "dyadic":
                v = dyadic(torch, gen, shape, "cuda")
            else:
                v = torch.randn(shape, generator=gen).cuda()
            v[0, 0] = 0.0  # a zero-norm row
            keys = torch.randint(-2**31, 2**31, (senders, 2), generator=gen,
                                 dtype=torch.int64).to(torch.int32).cuda()
            payload, norms = qsgd.qsgd_quantize_pack(v, keys, s)
            torch.cuda.synchronize()
            p_payload, p_norms = qsgd.qsgd_quantize_pack_plain(v, keys, s)
            where = f"s={s} block={block} nb={nb} senders={senders} {kind}"
            err["qsgd_quantize_pack"] = max(
                err["qsgd_quantize_pack"], float((norms - p_norms).abs().max()))
            if kind == "dyadic":
                check(torch.equal(payload, p_payload), f"payload differs, {where}")
                check(torch.equal(norms, p_norms), f"norms differ, {where}")
            else:
                check(torch.allclose(norms, p_norms, rtol=1e-6, atol=0),
                      f"norms beyond rtol 1e-6, {where}")
                codes = qsgd._unpack_words(payload.reshape(-1, payload.shape[-1]), bits)
                p_codes = qsgd._unpack_words(p_payload.reshape(-1, payload.shape[-1]),
                                             bits)
                diff = (codes - p_codes).abs()
                check(int(diff.max()) <= 1, f"a code differs by more than 1, {where}")
                check(float((diff > 0).float().mean()) <= 1e-3,
                      f"more than 0.1% of codes differ, {where}")
            rows = payload.reshape(-1, payload.shape[-1])
            out = qsgd.qsgd_unpack_dequantize(rows, norms.reshape(-1), s, block)
            torch.cuda.synchronize()
            p_out = qsgd.qsgd_unpack_dequantize_plain(rows, norms.reshape(-1), s, block)
            err["qsgd_unpack_dequantize"] = max(
                err["qsgd_unpack_dequantize"], float((out - p_out).abs().max()))
            check(torch.equal(out, p_out), f"dequantized values differ, {where}")
            n_cases += 1
    print(f"phase 2: kernel vs plain passed on {n_cases} cases "
          f"(s in {LEVELS}, block in {BLOCKS}, nb in {NBS}, and the main path's "
          f"10 leaves x 10 senders; dyadic + gaussian); "
          f"max |norm diff| {err['qsgd_quantize_pack']:.3g}, "
          f"max |dequantized diff| {err['qsgd_unpack_dequantize']:.3g}")
    return err


def main_path(torch, qsgd):
    """Phase 3: Fed-CHS through the port's entry points on the card."""
    from repro_torch.comm.channels import QSGDChannel, channel_wire_bits
    from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
    from repro_torch.core.simulation import FLTask
    from repro_torch.data.partition import assign_clusters, dirichlet_partition
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.models.classifier import make_classifier
    from repro_torch.utils import tree_leaves

    ds = make_dataset("mnist", seed=0)  # 60 000 train / 10 000 test
    clients = dirichlet_partition(ds.train_y, 100, 0.6, seed=0)
    clusters = assign_clusters(100, 10, seed=0)
    model = make_classifier("lenet", "mnist", ds.spec.image_shape, 10)
    task = FLTask(model, ds, clients, clusters, batch_size=32, seed=0)
    channel = QSGDChannel(16)
    cfg = FedCHSConfig(rounds=MAIN_ROUNDS, local_steps=MAIN_K, local_epochs=MAIN_E,
                       eval_every=2, channel=channel, seed=0)
    leaf_sizes = task.param_leaf_sizes()
    d = sum(leaf_sizes)
    J = MAIN_K // MAIN_E

    torch.cuda.synchronize()
    qsgd.reset_launches()
    t0 = time.perf_counter()
    res = run_fed_chs(task, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(qsgd.LAUNCHES)

    expected = MAIN_ROUNDS * J * len(leaf_sizes)
    print(f"phase 3: LeNet-MNIST Fed-CHS QSGD(16): {d} params in {len(leaf_sizes)} leaves, "
          f"{MAIN_ROUNDS} rounds in {secs:.2f} s ({secs / MAIN_ROUNDS:.3f} s/round, "
          f"evals included); launches {launches}, expected {expected} each")
    for name, n in launches.items():
        check(n == expected, f"{name} launched {n} times, expected {expected}")
    led = res.ledger
    up = channel_wire_bits(channel, d, leaf_sizes)
    visited = [int(e.sender.split(":")[1]) for e in led.events if e.hop == "es_to_es"]
    n_up = sum(J * len(clusters[m]) for m in visited)
    check(led.messages["client_to_es"] == n_up, "uplink message count")
    check(led.bits["client_to_es"] == n_up * up, "uplink bits differ from the closed form")
    print(f"  uplink {up} bits/message = channel_wire_bits; {n_up} messages; visits {visited}")
    print(f"  accuracy trace {res.test_acc} at rounds {res.rounds}; losses {res.train_loss}")
    check(all(math.isfinite(a) for a in res.test_acc + res.train_loss), "non-finite trace")
    check(res.final_acc() > 0.2, f"final accuracy {res.final_acc()} not above chance")
    check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(res.final_params)),
          "non-finite params")

    # where a main-path round spends the card's time: 2 rounds, profiled
    from torch.profiler import ProfilerActivity, profile

    cfg2 = FedCHSConfig(rounds=2, local_steps=MAIN_K, local_epochs=MAIN_E, eval_every=10**6,
                        channel=channel, seed=0)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        first = run_fed_chs(task, cfg2)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    again = run_fed_chs(task, cfg2)
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(first.final_params),
                                                 tree_leaves(again.final_params))),
          "a same-seed run on the card did not repeat bit for bit")
    events = [e for e in prof.key_averages()
              if e.device_time_total > 0 and str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    print(f"  a 2-round run repeats bit for bit; profiled (evals at rounds 0 and 1): "
          f"wall {wall_ms:.1f} ms, "
          f"kernels busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of wall)")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:8]:
        print(f"    {e.device_time_total / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")
    return launches, secs / MAIN_ROUNDS


def quickstart_and_cross_check(torch):
    """Phase 3b: the quickstart grad-mode config on the card; a small QSGD run
    on the card against the same run on the CPU's plain path."""
    from repro_torch.comm.channels import QSGDChannel
    from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
    from repro_torch.core.simulation import FLTask
    from repro_torch.data.partition import assign_clusters, dirichlet_partition
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.models.classifier import make_classifier
    from repro_torch.utils import tree_leaves

    ds = make_dataset("mnist", train_size=4000, test_size=1000, seed=0)
    clients = dirichlet_partition(ds.train_y, 20, 0.6, seed=0)
    clusters = assign_clusters(20, 4, seed=0)
    mlp = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    task = FLTask(mlp, ds, clients, clusters, batch_size=32, seed=0)
    t0 = time.perf_counter()
    res = run_fed_chs(task, FedCHSConfig(rounds=10, local_steps=10, eval_every=5))
    torch.cuda.synchronize()
    print(f"phase 3b: quickstart MLP grad mode, 10 rounds in {time.perf_counter() - t0:.2f} s; "
          f"accuracy {res.test_acc}")
    check(res.final_acc() > 0.5, "quickstart accuracy not above 0.5")
    check(res.ledger.bits["client_to_es"] == res.ledger.messages["client_to_es"]
          * task.num_params() * 32, "dense uplink bits")

    cfg = FedCHSConfig(rounds=4, local_steps=10, local_epochs=5, eval_every=2,
                       channel=QSGDChannel(16))
    on_card = run_fed_chs(task, cfg)
    cpu_task = FLTask(mlp, ds, clients, clusters, batch_size=32, seed=0, device="cpu")
    on_cpu = run_fed_chs(cpu_task, cfg)
    check(on_card.ledger.events == on_cpu.ledger.events, "card and CPU ledgers differ")
    a = torch.cat([t.reshape(-1).cpu() for t in tree_leaves(on_card.final_params)])
    b = torch.cat([t.reshape(-1) for t in tree_leaves(on_cpu.final_params)])
    rel = float((a - b).norm() / b.norm())
    acc_gap = max(abs(x - y) for x, y in zip(on_card.test_acc, on_cpu.test_acc))
    print(f"  QSGD run, card vs CPU plain path: params rel L2 {rel:.3g}, "
          f"accuracy gap {acc_gap:.3g}")
    check(rel <= 0.03 and acc_gap <= 0.02, "card run strays from the CPU run")


def time_launches(torch, fn, reps, flush):
    """Median of per-launch CUDA-event times (ms), L2 flushed before each."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timings(torch, qsgd, ref):
    """Phase 4: each kernel at the main path's shapes."""
    gen = torch.Generator().manual_seed(1)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    s, block = 16, 1024
    bits = ref.qsgd_code_bits(s)
    rows = []
    for label, senders, nb in (("fc1/w leaf x 10 senders", 10, 6272),
                               ("whole LeNet message", 1, 6745)):
        v = torch.randn((senders, nb, block), generator=gen).cuda()
        keys = torch.randint(-2**31, 2**31, (senders, 2), generator=gen,
                             dtype=torch.int64).to(torch.int32).cuda()
        payload, norms = qsgd.qsgd_quantize_pack(v, keys, s)
        prow, nrow = payload.reshape(-1, payload.shape[-1]), norms.reshape(-1)
        n = senders * nb * block
        q_bytes = 4 * n + bits * n // 8 + 4 * senders * nb + 8 * senders
        u_bytes = bits * n // 8 + 4 * senders * nb + 4 * n
        q_ops, u_ops = 8 * n, n + senders * nb  # f32 arithmetic; hash integer ops not counted
        cases = (
            ("qsgd_quantize_pack", q_bytes, q_ops,
             lambda: qsgd.qsgd_quantize_pack(v, keys, s),
             lambda: qsgd.qsgd_quantize_pack_plain(v, keys, s)),
            ("qsgd_unpack_dequantize", u_bytes, u_ops,
             lambda: qsgd.qsgd_unpack_dequantize(prow, nrow, s, block),
             lambda: qsgd.qsgd_unpack_dequantize_plain(prow, nrow, s, block)),
        )
        for name, nbytes, ops, kernel, plain in cases:
            ms = time_launches(torch, kernel, 50, flush)
            plain_ms = time_launches(torch, plain, 5, flush)
            bytes_ms, ops_ms = nbytes / MEM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
            row = {"name": name, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by}
            rows.append(row)
            print(f"phase 4: {name} [{label}, s={s}, block={block}]: {ms:.4f} ms median "
                  f"(plain {plain_ms:.3f} ms); bound {bound_ms:.4f} ms by {bound_by} "
                  f"({nbytes / 1e6:.1f} MB at 3.35 TB/s); {ms / bound_ms:.2f}x the bound")
    return rows


def main() -> None:
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found beside chip_smoke.py")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import qsgd, ref
    from repro_torch.utils import resolve_device

    resolve_device("cuda")  # full f32 products and convolutions
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib, log = qsgd.build()
    print(f"phase 1: built {lib.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    err = kernel_vs_plain(torch, qsgd, ref)
    launches, round_s = main_path(torch, qsgd)
    quickstart_and_cross_check(torch)
    rows = timings(torch, qsgd, ref)

    replaces = {"qsgd_quantize_pack": "src/repro/kernels/qsgd.py:194",
                "qsgd_unpack_dequantize": "src/repro/kernels/qsgd.py:227"}
    kernels = []
    for row in rows[:2]:  # the fc1/w leaf of 10 senders: the main path's largest launch
        name = row["name"]
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/qsgd.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
        })
    print(f"main path: {round_s:.3f} s per round on the card")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
