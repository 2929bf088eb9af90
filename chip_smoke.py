#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit, no result line):
  1. build every kernel source in src/repro_torch/csrc with nvcc for sm_90a,
     one nvcc per source, all at once; the ptxas lines of the kernels the
     paths lean on (no spill allowed), and the static SASS of the QSGD
     packing and unpacking kernels at block 1024 (the unpacking one must
     have no barrier);
  2. hold each kernel against its plain torch version on the card, on a grid
     of shapes and at every shape the main paths give it (each leaf of the
     LeNet and qwen3-0.6b messages, the LeNet leaves at the baselines'
     shapes: 100 senders for Hier-Local-QSGD's client grid, 10 for its ES
     hop, and s = 1, 7, 127 for `low_bit_channel(2/4/8)`).  QSGD: bit for
     bit on dyadic inputs
     (entries k * 2^-8, |k| <= 64, whose block norms are exact in any
     summation order); on Gaussian inputs norms at rtol 1e-6 and codes
     within 1 at no more than 0.1% of entries, and the dequantized values
     of the kernel's own payload bit for bit.  Flash attention: the
     reference's kernel-test sweep, causal and not, plus the LM paths'
     shapes (2 clients of batch 2, and one client under phase 3h), atol
     3e-5 in f32 and 2e-2 in bf16;
  3. the paths, through the entry points a user calls, each with the launch
     counts set to 0 just before it and read just after:
     a. LeNet-MNIST Fed-CHS with QSGD(16) uplinks at the paper's Appendix-A
        width (100 clients / 10 ESs, Dirichlet 0.6, batch 32, K=20, E=5), a
        few rounds; a profiled 2-round run that must repeat bit for bit;
        the quickstart MLP grad-mode config; a small QSGD run on the card
        held against the same run on the CPU's plain path;
     b. the main path of this slice: Fed-CHS trains qwen3-0.6b at full width
        and depth (751.6M params in 14 leaves, f32) on 4 token-stream clients
        in 2 clusters, QSGD(16) uplinks, self-attention through the flash
        kernel.  Launch counts must be exact, every uplink priced at the
        closed form, losses finite, the train loss and the held-out
        perplexity falling; then one warm round, timed without and then
        with the profiler;
     c. the dense-code QSGD API (`repro_torch.comm.qsgd_roundtrip`) over
        every leaf of the trained LM;
     d. a 2-layer smoke-config LM run on the card held against the same run
        on the CPU's plain path, beside two controls on the CPU that the
        bounds must reject: no update at all, and unquantized uplinks; then
        the same LM in grad mode (dense uplinks, no code to flip), held to
        GRAD_BOUND of its update, beside a wrong-mask control on the CPU;
     e. the paper's comparison at the Appendix-A scale of 3a: Fed-CHS
        QSGD(16) (3a's run), Hier-Local-QSGD with QSGD(16) on both hops,
        FedAvg and WRWGD dense, and Fed-CHS over Top-K(5%), Sign-SGD and
        4-bit QSGD; each arm's launch counts exact, every hop's messages and
        bits at the closed form, its s/round, peak memory, accuracy and
        traffic in the table `examples/compare_algorithms.py` prints;
     f. a small Hier-Local-QSGD MLP run (MomentumSGD, uneven clusters) and
        a dense FedAvg run with AdamW, each on the card against the same run
        on the CPU's plain path, beside a CPU control the bound must reject;
     g. partial participation and dynamic ES graphs at the scale of 3a:
        Fed-CHS QSGD(16) under Gilbert-Elliott churn, without and with the
        availability-aware rule (each round's uplinks exactly J per
        participant, B1 and B2 exactly J x leaves per trained round, the
        visit order the rule's own replay), then with two forced dark
        rounds (no launch, no client traffic, params bit-equal across
        them); Hier-Local-QSGD QSGD(16) under Bernoulli(0.7) churn
        (es_to_ps only from clusters that trained, ps_to_es to all);
        Fed-CHS on the IoV and LEO graphs (visit order equal to the
        scheduler's `precompute(dynamic=...)`); a masked MLP run on the card
        against the CPU's plain path; every arm of 3e and 3g replayed
        through netsim's edge-cloud network;
     h. the memory-lean engine: Hier-Local-QSGD QSGD(16) at
        client_microbatch 2 and FedAvg at 10 on 3e's task (ledgers equal to
        3e's, B1 and B2 once per leaf per client group, peak memory and
        s/round beside 3e's); qwen3-0.6b at full width and depth under
        `Precision()` (bf16 compute, f32 master, bf16 broadcasts),
        client_microbatch 1 and `LMFedModel(remat=True, flash=True)`, with
        the bf16 dense wire and with QSGD(16) uplinks (flash launched twice
        per layer per client group and step, B1 and B2 once per leaf per
        group, every hop at the closed form, loss and perplexity falling,
        peak memory beside 3b's), a warm round profiled, and the peak of one
        round with remat off and on at client_microbatch 2 and 1; the
        smoke LM and 3a's MLP task under the same knobs on the card against
        the CPU, each bounded by twice the CPU run's own gap from weights
        one bf16 ulp apart, beside controls the bounds must reject;
     i. the whole-run executor (every driver call above runs scanned: one
        captured CUDA graph, replayed per round): scanned runs against
        looped runs bit for bit, the launch counter against the profiler's
        count, a chunk of replays under the sync debug mode "error", and
        `run_sweep` lanes against solo runs;
     j. the host services at the scale of 3a, QSGD(16) uplinks: Fed-CHS and
        the three baselines with `RunTelemetry()` against the same runs
        without it (params, eval trace, ledger and launch counts equal),
        the tele's invariants, scanned against looped tele, a chunk of
        tapped replays under the sync debug mode "error", a Chrome trace
        with a netsim replay, the span names in a `torch.profiler` trace,
        and qwen3-0.6b at 3b's size tapped against untapped (3j-a); looped
        Fed-CHS checkpointed after 2 of 4 rounds and resumed, bit-equal to
        the uninterrupted scanned run, also under `Precision()`,
        `MomentumSGD()` and client_microbatch 2 (3j-b); the async drivers
        under benchmarks/fig_async.py's straggler and churn scenarios, each
        arm's B1 and B2 counts at leaves x cohort computations, every
        message at its closed-form bits, the sync anchor bit-equal to
        `run_fed_chs(local_epochs=K)`, a kill after an activation's save
        and the resume bit-equal, and time to accuracy 0.70 in simulated
        seconds beside sync Fed-CHS replayed through the same networks
        (3j-c);
  4. time each kernel at its path's shapes with CUDA events (L2 flushed
     before every launch, the card kept busy while the host enqueues it),
     beside its plain version, its bound and, for flash attention, torch's
     scaled_dot_product_attention.  Flash f32 is bounded by its 3xTF32 route
     (3 x operations at the TF32 rate) and also printed against the f32 FMA
     bound of the CUDA cores.  The packed pair is also timed at the
     comparison path's LeNet shapes (100 senders, 4-bit codes), and unpack
     -> dequantize over a whole uplink message of each path, one launch per
     leaf.  Rows after a kernel's first do not enter the kernels line.
The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}.  Needs a CUDA device; exits non-zero without
one, and outside a checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

LEVELS = (1, 3, 7, 15, 16, 63, 127)
BLOCKS = (32, 96, 128, 1024, 4096)  # W = block / 32 = 1, 3, 4, 32, 128
NBS = (1, 7, 6272)
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12    # H100 SXM TF32 tensor cores, dense
MAIN_ROUNDS, MAIN_K, MAIN_E = 6, 20, 5
# phase 3d grad mode: card-vs-CPU gap over the update p_T - p_0.  With the
# earlier flash kernel (f32 on the CUDA cores) an H100 80GB HBM3 at 700 W
# read 5.36e-6, and the wrong-mask control 1.2.
GRAD_BOUND = 1e-4
# phase 3f's AdamW run: card-vs-CPU gap over the update.  A ReLU classifier
# is not held to GRAD_BOUND: on the card one pre-activation of one sample
# can land on the other side of 0 than on the CPU, which moves that unit's
# gradients by a few percent, and AdamW's normalised steps carry it into
# every entry the unit touches.  The run also prints what its own CPU run
# reads against weights 1 + 2^-23 apart.
ADAM_BOUND = 0.05

# the LM path: qwen3-0.6b, 4 clients in 2 clusters (the example's i % 2)
LM_ARCH = "qwen3-0.6b"
LM_ROUNDS, LM_K, LM_E = 3, 2, 1
LM_CLIENTS, LM_BATCH, LM_SEQ = 4, 2, 512
LM_CLUSTERS = [[0, 2], [1, 3]]
LM_LR = 3.0  # constant plain-SGD step, finite at this width
LM_LEAVES, LM_PARAMS = 14, 751_632_384

# flash attention: the reference's kernel-test sweep, and the path's shape
FLASH_TS = ((128, 128), (64, 256), (200, 200), (50, 77), (80, 70))
FLASH_HEADS = ((4, 4), (8, 2), (16, 8))
FLASH_HDS = tuple(range(32, 257, 32))  # every head dim the kernel takes
FLASH_WINDOWS = (None, 16, 64)
FLASH_PATH = (LM_BATCH * 2, LM_SEQ, LM_SEQ, 16, 8, 128)  # B (2 clients x 2), T, S, H, Hkv, hd
FLASH_LEAN = (LM_BATCH, LM_SEQ, LM_SEQ, 16, 8, 128)  # phase 3h: one client (batch 2) at a time

REPLACES = {
    "qsgd_quantize_pack": ("src/repro_torch/csrc/qsgd.cu", "src/repro/kernels/qsgd.py:194"),
    "qsgd_unpack_dequantize": ("src/repro_torch/csrc/qsgd.cu", "src/repro/kernels/qsgd.py:227"),
    "qsgd_quantize": ("src/repro_torch/csrc/qsgd.cu", "src/repro/kernels/qsgd.py:85"),
    "qsgd_dequantize": ("src/repro_torch/csrc/qsgd.cu", "src/repro/kernels/qsgd.py:116"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:57"),
}


# kernels whose ptxas lines phase 1 prints, and which must not spill; the
# packing and unpacking kernels as the paths launch them: block 1024, s = 16
PACK_LEVELS = 16


def ptxas_shown(ref) -> dict[str, str]:
    bits = ref.qsgd_code_bits(PACK_LEVELS)
    return {"flash f32, hd 128": "flash_fwd_kernelIfLi128E",
            "flash bf16, hd 128": "flash_fwd_kernelI13__nv_bfloat16Li128E",
            f"quantize -> pack, block 1024, s = {PACK_LEVELS}":
                f"quantize_pack_regs_kernelILi8ELi{bits}E",
            f"unpack -> dequantize, block 1024, s = {PACK_LEVELS}":
                f"unpack_dequantize_regs_kernelILi{bits}E"}


def ptxas_kernels(log: str) -> list[tuple[str, int, int, int]]:
    """(mangled name, registers, spill-store bytes, spill-load bytes) of each
    kernel in an `nvcc -Xptxas -v` log."""
    out, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            spill = (nums[1], nums[2])
        elif "Used" in line and "registers" in line and name:
            regs = int(line.split("Used")[1].split()[0])
            out.append((name, regs, *spill))
            name, spill = None, (0, 0)
    return out


def sass_per_entry(lib, label: str, key: str) -> dict[str, int]:
    """Static SASS of one kernel (mangled name `key`) of library `lib`: its
    instructions over the 32 entries a lane handles per row (block 1024), and
    the count of a few of them.  Returns the counts."""
    from repro_torch.kernels import build

    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    body = sass.split("Function : ")
    fn = next(b for b in body if b.startswith("_Z") and key in b.split()[0])
    ops = []
    for ln in fn.splitlines():
        if ln.strip().startswith("/*") and "*/" in ln and ";" in ln:
            words = ln.split("*/", 1)[1].split(";")[0].split()
            words = words[1:] if words and words[0].startswith("@") else words
            if words:
                ops.append(words[0].split(".")[0])
    count = {op: ops.count(op) for op in ("VOTE", "LDG", "STG", "MUFU", "I2F", "F2I", "FRND",
                                          "BAR")}
    print(f"  SASS: {label} ({key}): {len(ops)} instructions, {len(ops) / 32:.1f} per entry "
          f"a lane handles in a row (static count); {count}")
    return count


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def dyadic(torch, gen, shape, device):
    return torch.randint(-64, 65, shape, generator=gen).to(torch.float32).mul(2.0**-8).to(device)


def lenet_leaf_blocks() -> list[int]:
    """Blocks per leaf of the LeNet path's message (LeNet-MNIST, block 1024)."""
    from repro_torch.models.classifier import make_classifier
    from repro_torch.utils import tree_leaves

    params = make_classifier("lenet", "mnist", (28, 28, 1), 10).init(0, "cpu")
    return [math.ceil(leaf.numel() / 1024) for leaf in tree_leaves(params)]


def lm_leaf_sizes(torch) -> list[int]:
    """Entries per leaf of the LM path's message (qwen3-0.6b, f32), from an
    init on the card."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.utils import tree_leaves

    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    sizes = [leaf.numel() for leaf in tree_leaves(init_params(cfg, 0, "cuda"))]
    torch.cuda.empty_cache()
    return sizes


def packed_vs_plain(torch, qsgd, ref, lm_sizes):
    """Phase 2, packed wire. Returns the largest |kernel - plain| of each
    kernel's output.  Cases: every (s, block, nb) of the grid with 2
    senders, every leaf of the LeNet message with its 10 senders, and every
    block count of the LM message's leaves with its 2 senders (s = 16)."""
    gen = torch.Generator().manual_seed(0)
    err = {"qsgd_quantize_pack": 0.0, "qsgd_unpack_dequantize": 0.0}
    n_cases = 0
    lm_blocks = sorted({math.ceil(n / 1024) for n in lm_sizes})
    grid = [(s, block, nb, 2) for s in LEVELS for block in BLOCKS for nb in NBS]
    grid += [(16, 1024, nb, 10) for nb in lenet_leaf_blocks()]
    grid += [(16, 1024, nb, 2) for nb in lm_blocks]
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
    print(f"phase 2: packed QSGD kernels vs plain passed on {n_cases} cases "
          f"(s in {LEVELS}, block in {BLOCKS}, nb in {NBS}; the LeNet message's "
          f"10 leaves x 10 senders; the {LM_ARCH} message's {len(lm_sizes)} leaves, "
          f"nb in {lm_blocks}, x 2 senders; dyadic + gaussian); "
          f"max |norm diff| {err['qsgd_quantize_pack']:.3g}, "
          f"max |dequantized diff| {err['qsgd_unpack_dequantize']:.3g}")
    return err


BASELINE_SHAPES = [(16, 100), (16, 10), (1, 10), (7, 10), (127, 10)]  # (s, senders)


def baseline_shapes_vs_plain(torch, qsgd, ref, err):
    """Phase 2, packed wire at the comparison path's shapes: every LeNet leaf
    with 100 senders (Hier-Local-QSGD's flattened client grid) and with 10
    (its ES hop) at s = 16, and with 10 senders at s = 1, 7, 127
    (`low_bit_channel(2/4/8)`).  Inputs are drawn on the card; the rules
    of `packed_vs_plain`.  Updates `err` in place."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    n_cases = 0
    for (s, senders), nb in itertools.product(BASELINE_SHAPES, lenet_leaf_blocks()):
        bits = ref.qsgd_code_bits(s)
        for kind in ("dyadic", "gaussian"):
            shape = (senders, nb, 1024)
            if kind == "dyadic":
                v = torch.randint(-64, 65, shape, generator=gen, device="cuda")
                v = v.to(torch.float32).mul_(2.0**-8)
            else:
                v = torch.randn(shape, generator=gen, device="cuda")
            v[senders - 1] = 0.0  # a padded slot's zero delta
            keys = torch.randint(-2**31, 2**31, (senders, 2), generator=gen, device="cuda",
                                 dtype=torch.int64).to(torch.int32)
            payload, norms = qsgd.qsgd_quantize_pack(v, keys, s)
            p_payload, p_norms = qsgd.qsgd_quantize_pack_plain(v, keys, s)
            where = f"s={s} nb={nb} senders={senders} {kind}"
            err["qsgd_quantize_pack"] = max(
                err["qsgd_quantize_pack"], float((norms - p_norms).abs().max()))
            if kind == "dyadic":
                check(torch.equal(payload, p_payload), f"payload differs, {where}")
                check(torch.equal(norms, p_norms), f"norms differ, {where}")
            else:
                check(torch.allclose(norms, p_norms, rtol=1e-6, atol=0),
                      f"norms beyond rtol 1e-6, {where}")
                rows = payload.reshape(-1, payload.shape[-1])
                diff = (qsgd._unpack_words(rows, bits)
                        - qsgd._unpack_words(p_payload.reshape(rows.shape), bits)).abs()
                check(int(diff.max()) <= 1, f"a code differs by more than 1, {where}")
                check(float((diff > 0).float().mean()) <= 1e-3,
                      f"more than 0.1% of codes differ, {where}")
            del p_payload, p_norms, v
            rows, nrows = payload.reshape(-1, payload.shape[-1]), norms.reshape(-1)
            out = qsgd.qsgd_unpack_dequantize(rows, nrows, s, 1024)
            p_out = qsgd.qsgd_unpack_dequantize_plain(rows, nrows, s, 1024)
            err["qsgd_unpack_dequantize"] = max(
                err["qsgd_unpack_dequantize"], float((out - p_out).abs().max()))
            check(torch.equal(out, p_out), f"dequantized values differ, {where}")
            check(not bool(out.reshape(senders, -1)[senders - 1].any()),
                  f"a zero delta does not decode to zeros, {where}")
            del out, p_out, payload, norms
            n_cases += 1
    torch.cuda.empty_cache()
    print(f"phase 2: packed QSGD kernels vs plain at the baselines' shapes passed on "
          f"{n_cases} cases ((s, senders) in {BASELINE_SHAPES} x the LeNet message's "
          f"10 leaves; dyadic + gaussian, the last sender all zero); max |norm diff| "
          f"{err['qsgd_quantize_pack']:.3g}, max |dequantized diff| "
          f"{err['qsgd_unpack_dequantize']:.3g}")


def dense_codes_vs_plain(torch, qsgd, lm_sizes):
    """Phase 2, dense codes: every (s, block, nb) of the grid, and the
    padded row count of every leaf of the LM message (s = 16, block 1024,
    padded to tiles of 8 rows as `ops.qsgd_quantize` pads them); one key."""
    gen = torch.Generator().manual_seed(2)
    err = {"qsgd_quantize": 0.0, "qsgd_dequantize": 0.0}
    n_cases = 0
    per_tile = 1024 * 8
    lm_rows = sorted({-(-n // per_tile) * 8 for n in lm_sizes})
    grid = list(itertools.product(LEVELS, BLOCKS, (8, 56, 6272)))
    grid += [(16, 1024, nb) for nb in lm_rows]
    for s, block, nb in grid:
        for kind in ("dyadic", "gaussian"):
            if kind == "dyadic":
                v = dyadic(torch, gen, (nb, block), "cuda")
            else:
                v = torch.randn((nb, block), generator=gen).cuda()
            v[0] = 0.0  # a zero-norm row
            key = torch.randint(-2**31, 2**31, (2,), generator=gen,
                                dtype=torch.int64).to(torch.int32).cuda()
            q, norms = qsgd.qsgd_quantize_blocks(v, key, s)
            torch.cuda.synchronize()
            p_q, p_norms = qsgd.qsgd_quantize_blocks_plain(v, key, s)
            where = f"s={s} block={block} nb={nb} {kind}"
            err["qsgd_quantize"] = max(err["qsgd_quantize"],
                                       float((norms - p_norms).abs().max()))
            if kind == "dyadic":
                check(torch.equal(q, p_q), f"dense codes differ, {where}")
                check(torch.equal(norms, p_norms), f"dense-code norms differ, {where}")
            else:
                check(torch.allclose(norms, p_norms, rtol=1e-6, atol=0),
                      f"dense-code norms beyond rtol 1e-6, {where}")
                diff = (q.int() - p_q.int()).abs()
                check(int(diff.max()) <= 1, f"a dense code differs by more than 1, {where}")
                check(float((diff > 0).float().mean()) <= 1e-3,
                      f"more than 0.1% of dense codes differ, {where}")
            out = qsgd.qsgd_dequantize_blocks(q, norms, s)
            torch.cuda.synchronize()
            p_out = qsgd.qsgd_dequantize_blocks_plain(q, norms, s)
            err["qsgd_dequantize"] = max(err["qsgd_dequantize"],
                                         float((out - p_out).abs().max()))
            check(torch.equal(out, p_out), f"dense dequantized values differ, {where}")
            n_cases += 1
    print(f"phase 2: dense-code QSGD kernels vs plain passed on {n_cases} cases (s in "
          f"{LEVELS}, block in {BLOCKS}, nb in (8, 56, 6272); the {LM_ARCH} leaves' "
          f"padded rows {lm_rows} at s=16; dyadic + gaussian); "
          f"max |norm diff| {err['qsgd_quantize']:.3g}, "
          f"max |dequantized diff| {err['qsgd_dequantize']:.3g}")
    return err


def flash_inputs(torch, gen, B, T, S, H, Hkv, hd, dtype):
    return [torch.randn(shape, generator=gen).to(dtype).cuda()
            for shape in ((B, T, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]


def flash_vs_plain(torch, fa):
    """Phase 2, flash attention: the sweep (causal with every window; not
    causal without and with a window) and the path's shape, f32 and bf16.
    Returns the largest |kernel - plain| over the f32 cases (the path's
    dtype)."""
    gen = torch.Generator().manual_seed(3)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    tol = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
    masks = [(True, w) for w in FLASH_WINDOWS] + [(False, None), (False, 16)]
    cases = [(2, T, S, H, Hkv, hd) + m for (T, S), (H, Hkv), hd, m in itertools.product(
        FLASH_TS, FLASH_HEADS, FLASH_HDS, masks)]
    cases += [FLASH_PATH + (True, None), FLASH_LEAN + (True, None)]
    n_cases = 0

    def held(q, k, v, causal, window, where):
        nonlocal n_cases
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        d = float((out.float() - want.float()).abs().max())
        check(out.dtype == q.dtype and out.shape == q.shape and d <= tol[q.dtype],
              f"flash attention off by {d:.3g} at {where} causal={causal} window={window} "
              f"{q.dtype}")
        worst[q.dtype] = max(worst[q.dtype], d)
        n_cases += 1

    for (B, T, S, H, Hkv, hd, causal, window), dtype in itertools.product(cases, tol):
        q, k, v = flash_inputs(torch, gen, B, T, S, H, Hkv, hd, dtype)
        held(q, k, v, causal, window, f"B={B} T={T} S={S} H={H} Hkv={Hkv} hd={hd}")
    for dtype in tol:
        # views into one fused projection (aligned rows, read through strides)
        B, T, H, Hkv, hd = 2, 96, 8, 2, 64
        fused = torch.randn((B, T, (H + 2 * Hkv) * hd), generator=gen).to(dtype).cuda()
        q = fused[..., :H * hd].reshape(B, T, H, hd)
        k = fused[..., H * hd:(H + Hkv) * hd].reshape(B, T, Hkv, hd)
        v = fused[..., (H + Hkv) * hd:].reshape(B, T, Hkv, hd)
        check(fa._rows_aligned(q) and not q.is_contiguous(), "the fused views")
        for causal, window in masks:
            held(q, k, v, causal, window, "fused-projection views")
        # views one element past an aligned base: the wrapper's aligned copies
        views = []
        for shape in ((B, 70, H, 96), (B, 90, Hkv, 96), (B, 90, Hkv, 96)):
            flat = torch.randn(math.prod(shape) + 1, generator=gen).to(dtype).cuda()
            views.append(flat[1:].view(shape))
        check(not any(fa._rows_aligned(x) for x in views), "the misaligned views")
        for causal, window in masks:
            held(*views, causal, window, "misaligned views")
    print(f"phase 2: flash attention vs plain passed on {n_cases} cases (T,S in {FLASH_TS}, "
          f"H,Hkv in {FLASH_HEADS}, hd in {FLASH_HDS}, (causal, window) in {masks}; the LM "
          f"path's shape {FLASH_PATH}; fused-projection views and views off 16-byte "
          f"alignment; f32 + bf16), and the lean path's {FLASH_LEAN}; max |diff| "
          f"{worst[torch.float32]:.3g} in f32, {worst[torch.bfloat16]:.3g} in bf16")
    return worst[torch.float32]


def lenet_path(torch, build):
    """Phase 3a: Fed-CHS on LeNet-MNIST through the port's entry points."""
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
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    res = run_fed_chs(task, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    expected = MAIN_ROUNDS * J * len(leaf_sizes)
    print(f"phase 3a: LeNet-MNIST Fed-CHS QSGD(16): {d} params in {len(leaf_sizes)} leaves, "
          f"{MAIN_ROUNDS} rounds in {secs:.2f} s ({secs / MAIN_ROUNDS:.3f} s/round, "
          f"evals included); launches {launches}, expected {expected} of each packed kernel")
    for name, n in launches.items():
        want = expected if name in ("qsgd_quantize_pack", "qsgd_unpack_dequantize") else 0
        check(n == want, f"{name} launched {n} times, expected {want}")
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

    # where a LeNet round spends the card's time: 2 rounds, profiled
    cfg2 = FedCHSConfig(rounds=2, local_steps=MAIN_K, local_epochs=MAIN_E, eval_every=10**6,
                        channel=channel, seed=0)
    first, wall_ms, events = profiled(torch, lambda: run_fed_chs(task, cfg2))
    again, plain_ms = timed(torch, lambda: run_fed_chs(task, cfg2))
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(first.final_params),
                                                 tree_leaves(again.final_params))),
          "a same-seed run on the card did not repeat bit for bit")
    print("  a 2-round run repeats bit for bit; profiled (evals at rounds 0 and 1):")
    print_profile(wall_ms, plain_ms, events, 8)
    # phase 3e's Fed-CHS arm: this run's ledger and accuracy, the warm 2-round
    # run's time (the first run on the card pays one-time costs)
    arm = {"name": "Fed-CHS QSGD(16)", "res": res, "s_per_round": plain_ms / 2e3,
           "rounds": MAIN_ROUNDS, "peak_gb": peak_gb, "launches": launches}
    return task, arm


def timed(torch, run):
    """(result, wall ms) of `run()`, ended by a synchronize."""
    t0 = time.perf_counter()
    result = run()
    torch.cuda.synchronize()
    return result, (time.perf_counter() - t0) * 1e3


def profiled(torch, run):
    """(result, wall ms, CUDA kernel events) of `run()` under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_time_total > 0 and str(e.device_type).endswith("CUDA")]
    return result, wall_ms, events


def print_profile(wall_ms, plain_ms, events, top):
    """Kernel time under the profiler beside the wall time of the same run
    with and without it (the profiler's per-op cost inflates the profiled
    wall time, and can inflate kernel times too)."""
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    print(f"    wall {plain_ms:.1f} ms unprofiled, {wall_ms:.1f} ms profiled; kernel time "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of the profiled wall, "
          f"{100 * busy_ms / plain_ms:.1f}% of the unprofiled)")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:top]:
        print(f"    {e.device_time_total / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")


def print_gemm_share(events, plain_ms):
    """The matrix-product kernels' share of the profiled kernel time."""
    busy = sum(e.device_time_total for e in events)
    gemm = sum(e.device_time_total for e in events
               if any(k in e.key.lower() for k in ("gemm", "xmma", "cutlass", "nvjet")))
    print(f"    matrix-product kernels {gemm / 1e3:.1f} ms = {100 * gemm / busy:.1f}% of the "
          f"kernel time ({100 * gemm / 1e3 / plain_ms:.1f}% of the unprofiled wall)")


def quickstart_and_cross_check(torch):
    """Phase 3a, continued: the quickstart grad-mode config on the card; a
    small QSGD run on the card against the same run on the CPU's plain path."""
    from repro_torch.comm.channels import QSGDChannel
    from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
    from repro_torch.core.simulation import FLTask
    from repro_torch.data.partition import assign_clusters, dirichlet_partition
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.models.classifier import make_classifier

    ds = make_dataset("mnist", train_size=4000, test_size=1000, seed=0)
    clients = dirichlet_partition(ds.train_y, 20, 0.6, seed=0)
    clusters = assign_clusters(20, 4, seed=0)
    mlp = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    task = FLTask(mlp, ds, clients, clusters, batch_size=32, seed=0)
    t0 = time.perf_counter()
    res = run_fed_chs(task, FedCHSConfig(rounds=10, local_steps=10, eval_every=5))
    torch.cuda.synchronize()
    print(f"  quickstart MLP grad mode, 10 rounds in {time.perf_counter() - t0:.2f} s; "
          f"accuracy {res.test_acc}")
    check(res.final_acc() > 0.5, "quickstart accuracy not above 0.5")
    check(res.ledger.bits["client_to_es"] == res.ledger.messages["client_to_es"]
          * task.num_params() * 32, "dense uplink bits")

    cfg = FedCHSConfig(rounds=4, local_steps=10, local_epochs=5, eval_every=2,
                       channel=QSGDChannel(16))
    on_card = run_fed_chs(task, cfg)
    cpu_task = FLTask(mlp, ds, clients, clusters, batch_size=32, seed=0, device="cpu")
    p0 = cpu_task.init_params()
    on_cpu = run_fed_chs(cpu_task, cfg)
    rel, upd_rel, upd, gap = card_vs_cpu(torch, on_card, on_cpu, p0)
    print(f"  MLP QSGD run, card vs CPU plain path: params rel L2 {rel:.3g} ({upd_rel:.3g} "
          f"of the update p_T - p_0, which is {upd:.3g} of p_T), accuracy gap {gap:.3g}")
    check(rel <= 0.03 and upd_rel <= 0.03 and gap <= 0.02, "card run strays from the CPU run")


def flat_params(torch, params):
    from repro_torch.utils import tree_leaves

    return torch.cat([t.reshape(-1).cpu() for t in tree_leaves(params)])


def card_vs_cpu(torch, on_card, on_cpu, p0):
    """Ledgers must be equal.  Returns the params' gap |p_card - p_cpu| in
    relative L2, the same gap relative to the CPU run's update p_T - p_0,
    the update's size relative to p_T (what a run that never updates reads),
    and the largest metric gap."""
    check(on_card.ledger.events == on_cpu.ledger.events, "card and CPU ledgers differ")
    check(on_card.rounds == on_cpu.rounds, "card and CPU eval rounds differ")
    a, b = flat_params(torch, on_card.final_params), flat_params(torch, on_cpu.final_params)
    diff, update = float((a - b).norm()), float((b - flat_params(torch, p0)).norm())
    gap = max(abs(x - y) for x, y in zip(on_card.test_acc, on_cpu.test_acc))
    return diff / float(b.norm()), diff / update, update / float(b.norm()), gap


def lm_task(cfg, device=None, init_on_cpu=False, remat=False, scale=1.0, **source_kw):
    """The LM task of the example: `LMFedModel` + `TokenSource` clients.
    `scale` multiplies every initial weight (drawn on the CPU)."""
    from repro_torch.core.simulation import FLTask
    from repro_torch.data.sources import TokenSource
    from repro_torch.models.fed import LMFedModel

    model = LMFedModel(cfg, flash=True, remat=remat)
    if init_on_cpu:  # the same initial weights on the card and on the CPU
        model = _CpuInit(model, scale)
    source = TokenSource(cfg.vocab_size, topics=4, seed=0, **source_kw)
    return FLTask.from_source(model, source, LM_CLUSTERS, seed=0, device=device)


class _CpuInit:
    """An LMFedModel whose weights are drawn on the CPU, scaled, then moved."""

    def __init__(self, model, scale=1.0):
        self.model, self.scale = model, scale

    def __getattr__(self, name):
        return getattr(self.model, name)

    def init(self, seed=0, device=None):
        from repro_torch.utils import tree_map

        return tree_map(lambda t: (t * self.scale).to(device), self.model.init(seed, "cpu"))


def lm_path(torch, build):
    """Phase 3b: the main path, qwen3-0.6b Fed-CHS with QSGD(16) uplinks."""
    from repro_torch.comm.channels import QSGDChannel, channel_wire_bits
    from repro_torch.configs.registry import get_config
    from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
    from repro_torch.utils import tree_leaves

    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    task = lm_task(cfg, num_clients=LM_CLIENTS, batch_size=LM_BATCH, seq_len=LM_SEQ)
    channel = QSGDChannel(16)
    config = FedCHSConfig(rounds=LM_ROUNDS, local_steps=LM_K, local_epochs=LM_E, eval_every=1,
                          channel=channel, seed=0, schedule=lambda k: LM_LR)
    J = LM_K // LM_E

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    res = run_fed_chs(task, config)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    leaf_sizes = [t.numel() for t in tree_leaves(res.final_params)]
    d = sum(leaf_sizes)
    evals = len(res.rounds)
    n_eval_batches = len(task.source.eval_data()["tokens"])
    want = {"flash_attention": cfg.num_layers * (LM_ROUNDS * LM_K + evals * n_eval_batches),
            "qsgd_quantize_pack": LM_ROUNDS * J * len(leaf_sizes),
            "qsgd_unpack_dequantize": LM_ROUNDS * J * len(leaf_sizes),
            "qsgd_quantize": 0, "qsgd_dequantize": 0}
    print(f"phase 3b: {LM_ARCH} Fed-CHS QSGD(16), flash attention: {d} params in "
          f"{len(leaf_sizes)} leaves, {cfg.num_layers} layers; {LM_CLIENTS} clients in "
          f"clusters {LM_CLUSTERS}, batch {LM_BATCH} x {LM_SEQ} tokens, K={LM_K}, E={LM_E}, "
          f"lr {LM_LR}; {LM_ROUNDS} rounds in {secs:.2f} s ({secs / LM_ROUNDS:.3f} s/round, "
          f"{evals} evals of {n_eval_batches} batches included); peak memory {peak_gb:.2f} GB")
    print(f"  launches {launches}, expected {want}")
    check(len(leaf_sizes) == LM_LEAVES and d == LM_PARAMS,
          f"{len(leaf_sizes)} leaves / {d} params, expected {LM_LEAVES} / {LM_PARAMS}")
    for name, n in want.items():
        check(launches[name] == n, f"{name} launched {launches[name]} times, expected {n}")
    led = res.ledger
    up = channel_wire_bits(channel, d, leaf_sizes)
    visited = [int(e.sender.split(":")[1]) for e in led.events if e.hop == "es_to_es"]
    n_up = sum(J * len(LM_CLUSTERS[m]) for m in visited)
    check(led.messages["client_to_es"] == n_up, "LM uplink message count")
    check(led.bits["client_to_es"] == n_up * up, "LM uplink bits differ from the closed form")
    print(f"  uplink {up} bits/message = channel_wire_bits ({32 * d / up:.2f}x under f32); "
          f"{n_up} messages; visits {visited}")
    print(f"  perplexity {res.test_acc} at rounds {res.rounds}; train loss {res.train_loss}")
    check(all(math.isfinite(x) for x in res.test_acc + res.train_loss), "non-finite LM trace")
    check(res.train_loss[-1] < res.train_loss[0], "the LM's train loss did not fall")
    check(res.test_acc[-1] < res.test_acc[0],
          "the LM's perplexity on the fixed held-out batches did not fall")
    check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(res.final_params)),
          "non-finite LM params")

    # one round again, warm: unprofiled for its time, then profiled
    one = FedCHSConfig(rounds=1, local_steps=LM_K, local_epochs=LM_E, eval_every=1,
                       channel=channel, seed=0, schedule=lambda k: LM_LR)
    _, plain_ms = timed(torch, lambda: run_fed_chs(task, one))
    _, wall_ms, events = profiled(torch, lambda: run_fed_chs(task, one))
    print(f"  one warm round (K={LM_K} steps, an eval of {n_eval_batches} batches), "
          f"unprofiled then profiled:")
    print_profile(wall_ms, plain_ms, events, 12)
    print_gemm_share(events, plain_ms)
    return launches, plain_ms / 1e3, res.final_params, peak_gb


def dense_code_path(torch, build, params):
    """Phase 3c: the dense-code QSGD API over every leaf of the trained LM,
    one key per leaf (`split` of one run key)."""
    from repro_torch import comm
    from repro_torch.core.prng import PRNGKey, split
    from repro_torch.utils import tree_leaves

    leaves = tree_leaves(params)
    keys = split(PRNGKey(0), len(leaves))
    torch.cuda.synchronize()
    build.reset_launches()
    worst = 0.0
    for leaf, key in zip(leaves, keys):
        out = comm.qsgd_roundtrip(leaf, key, s=16)
        check(out.shape == leaf.shape and bool(torch.isfinite(out).all()),
              "dense-code roundtrip: bad shape or non-finite values")
        worst = max(worst, float((out - leaf).norm() / leaf.norm()))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    print(f"phase 3c: dense-code qsgd_roundtrip (s=16) over the LM's {len(leaves)} leaves: "
          f"launches {launches}; largest relative L2 error {worst:.3f}")
    for name in ("qsgd_quantize", "qsgd_dequantize"):
        check(launches[name] == len(leaves), f"{name} launched {launches[name]} times")
    check(worst < 1.5, "a dense-code roundtrip error beyond the QSGD variance bound")
    return launches


def lm_cross_check(torch):
    """Phase 3d: a 2-layer smoke-config LM run, card against CPU, held to
    params within 3% relative L2 and perplexity within 2%.  Two controls on
    the CPU show that these bounds reject a wrong run: one that never
    updates (it reads the update's size away) and one whose uplinks skip
    the quantizer (dense uplinks, the same config otherwise)."""
    from repro_torch.comm.channels import DenseChannel, QSGDChannel
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs

    cfg = smoke_config(LM_ARCH)
    config = FedCHSConfig(rounds=4, local_steps=4, local_epochs=2, eval_every=2,
                          channel=QSGDChannel(16), seed=0, schedule=lambda k: 0.3)
    kw = dict(num_clients=4, batch_size=2, seq_len=64)
    on_card = run_fed_chs(lm_task(cfg, init_on_cpu=True, **kw), config)
    cpu_task = lm_task(cfg, device="cpu", init_on_cpu=True, **kw)
    p0 = cpu_task.init_params()
    on_cpu = run_fed_chs(cpu_task, config)
    rel, upd_rel, upd, _ = card_vs_cpu(torch, on_card, on_cpu, p0)
    ppl = max(abs(x / y - 1) for x, y in zip(on_card.test_acc, on_cpu.test_acc))
    dense = run_fed_chs(lm_task(cfg, device="cpu", init_on_cpu=True, **kw),
                        dataclasses.replace(config, channel=DenseChannel()))
    b = flat_params(torch, on_cpu.final_params)
    ctrl_rel = float((flat_params(torch, dense.final_params) - b).norm() / b.norm())
    ctrl_ppl = max(abs(x / y - 1) for x, y in zip(dense.test_acc, on_cpu.test_acc))
    print(f"phase 3d: {LM_ARCH} smoke-config LM (2 layers, d_model {cfg.d_model}) QSGD run, "
          f"card vs CPU plain path: params rel L2 {rel:.3g} ({upd_rel:.3g} of the update "
          f"p_T - p_0), perplexity within {ppl:.3g} (card {on_card.test_acc}, CPU "
          f"{on_cpu.test_acc}); controls on the CPU: no update reads {upd:.3g}, dense "
          f"uplinks read {ctrl_rel:.3g} and perplexity {ctrl_ppl:.3g} (perplexity "
          f"{dense.test_acc})")
    check(rel <= 0.03 and ppl <= 0.02, "card LM run strays from the CPU run")
    check(upd > 0.03, "the params bound would pass a run that never updates")
    check(ctrl_rel > 0.03 and ctrl_ppl > 0.02,
          "the bounds would pass a run whose uplinks skip the quantizer")
    lm_grad_cross_check(torch, cfg, kw)


def lm_grad_cross_check(torch, cfg, kw):
    """Phase 3d, continued: the same smoke-config LM in grad mode (dense
    uplinks, E = 1, 2 rounds, flash on), card against CPU.  No code can flip
    here, so only float order separates the runs, and the gap is held to
    GRAD_BOUND of the update p_T - p_0.  A CPU control with the wrong mask
    (a 16-key window in place of full causal attention) must read above it."""
    from repro_torch.comm.channels import DenseChannel
    from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs

    config = FedCHSConfig(rounds=2, local_steps=4, local_epochs=1, eval_every=1,
                          channel=DenseChannel(), seed=0, schedule=lambda k: 0.3)
    on_card = run_fed_chs(lm_task(cfg, init_on_cpu=True, **kw), config)
    cpu_task = lm_task(cfg, device="cpu", init_on_cpu=True, **kw)
    p0 = cpu_task.init_params()
    on_cpu = run_fed_chs(cpu_task, config)
    _, upd_rel, upd, _ = card_vs_cpu(torch, on_card, on_cpu, p0)
    ppl = max(abs(x / y - 1) for x, y in zip(on_card.test_acc, on_cpu.test_acc))
    wrong = dataclasses.replace(cfg, block_pattern=("local",), sliding_window=16)
    ctrl = run_fed_chs(lm_task(wrong, device="cpu", init_on_cpu=True, **kw), config)
    _, ctrl_rel, _, _ = card_vs_cpu(torch, ctrl, on_cpu, p0)
    print(f"  grad mode (dense uplinks, E=1, 2 rounds), card vs CPU plain path: params gap "
          f"{upd_rel:.3g} of the update p_T - p_0 (which is {upd:.3g} of p_T; bound "
          f"{GRAD_BOUND:g}), perplexity within {ppl:.3g}; wrong-mask control on the CPU "
          f"(window 16) reads {ctrl_rel:.3g}")
    check(upd_rel <= GRAD_BOUND, "card grad-mode LM run strays from the CPU run")
    check(ctrl_rel > GRAD_BOUND, "the grad-mode bound would pass a wrong attention mask")


COMPARE_ROUNDS, WALK_ROUNDS = 2, 20  # phase 3e's cuts of the paper's 200 rounds


def comparison_arm(torch, build, name, run, rounds):
    """One arm of phase 3e: launch counts reset just before it and read just
    after; its s/round (a synchronize ends it, evals included) and peak
    memory."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return {"name": name, "res": res, "s_per_round": secs / rounds, "rounds": rounds,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": dict(build.LAUNCHES)}


PS_HOPS = ("es_to_ps", "ps_to_es", "client_to_ps", "ps_to_client")


def comparison_path(torch, build, task, chs_arm):
    """Phase 3e: the paper's comparison (Table 1, Fig. 2) at the Appendix-A
    scale of phase 3a, through the port's entry points: 100 clients, 10 ESs,
    K = 20, E = 5.  Each arm's launches exact, every hop's messages and bits
    at the closed form, PS traffic zero for Fed-CHS, finite traces and
    params; then the table of `examples/compare_algorithms.py`."""
    from repro_torch.comm.channels import (
        DenseChannel,
        QSGDChannel,
        TopKChannel,
        channel_wire_bits,
        low_bit_channel,
    )
    from repro_torch.core.baselines import (
        FedAvgConfig,
        HierLocalQSGDConfig,
        WRWGDConfig,
        run_fedavg,
        run_hier_local_qsgd,
        run_wrwgd,
    )
    from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
    from repro_torch.utils import tree_leaves

    R, K, E = COMPARE_ROUNDS, MAIN_K, MAIN_E
    J, M, n = K // E, task.num_clusters, task.num_clients
    leaf_sizes = task.param_leaf_sizes()
    L, d = len(leaf_sizes), sum(leaf_sizes)
    down = DenseChannel().message_bits(d)
    qsgd16 = QSGDChannel(16)
    arms = [chs_arm]
    for name, run, config, rounds in (
            ("Hier-Local-QSGD QSGD(16)", run_hier_local_qsgd,
             HierLocalQSGDConfig(rounds=R, local_steps=K, local_epochs=E, eval_every=1,
                                 qsgd_levels=16), R),
            ("FedAvg", run_fedavg, FedAvgConfig(rounds=R, local_steps=K, eval_every=1), R),
            ("WRWGD", run_wrwgd, WRWGDConfig(rounds=WALK_ROUNDS, local_steps=K, eval_every=10),
             WALK_ROUNDS)):
        arms.append(comparison_arm(torch, build, name, lambda run=run, c=config: run(task, c),
                                   rounds))
        arms[-1]["config"] = config  # phase 3i runs it looped
    chs_channels = {"Fed-CHS Top-5%": TopKChannel(0.05), "Fed-CHS Sign-SGD": low_bit_channel(1),
                    "Fed-CHS QSGD(7), 4-bit": low_bit_channel(4)}
    for name, channel in chs_channels.items():
        arms.append(comparison_arm(torch, build, name, lambda channel=channel: run_fed_chs(
            task, FedCHSConfig(rounds=R, local_steps=K, local_epochs=E, eval_every=1,
                               channel=channel, seed=0)), R))
    chs_channels["Fed-CHS QSGD(16)"] = qsgd16

    packed = ("qsgd_quantize_pack", "qsgd_unpack_dequantize")
    for arm in arms:
        name, res, led = arm["name"], arm["res"], arm["res"].ledger
        if name.startswith("Fed-CHS"):
            visited = [int(e.sender.split(":")[1]) for e in led.events if e.hop == "es_to_es"]
            n_up = sum(J * len(task.cluster_members[m]) for m in visited)
            up = channel_wire_bits(chs_channels[name], d, leaf_sizes)
            want = {"client_to_es": (n_up, up), "es_to_client": (n_up, down),
                    "es_to_es": (len(visited), down)}
            kernels = {"Fed-CHS QSGD(16)": MAIN_ROUNDS * J * L,
                       "Fed-CHS QSGD(7), 4-bit": R * J * L}.get(name, 0)
        elif name.startswith("Hier"):
            want = {"client_to_es": (R * J * n, channel_wire_bits(qsgd16, d, leaf_sizes)),
                    "es_to_client": (R * J * n, down),
                    "es_to_ps": (R * M, channel_wire_bits(qsgd16, d, leaf_sizes)),
                    "ps_to_es": (R * M, down)}
            kernels = R * (J * L + L)
        elif name == "FedAvg":
            want = {"client_to_ps": (R * n, channel_wire_bits(DenseChannel(), d, leaf_sizes)),
                    "ps_to_client": (R * n, down)}
            kernels = 0
        else:
            want = {"client_to_client": (WALK_ROUNDS, down)}
            kernels = 0
        got = {h: (led.messages[h], led.bits[h]) for h in led.messages if led.messages[h]}
        check(got == {h: (m, m * b) for h, (m, b) in want.items()},
              f"{name}: ledger {got} differs from the closed form {want}")
        for k, v in arm["launches"].items():
            check(v == (kernels if k in packed else 0),
                  f"{name}: {k} launched {v} times, expected {kernels if k in packed else 0}")
        check(all(math.isfinite(x) for x in res.test_acc + res.train_loss),
              f"{name}: non-finite trace")
        check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(res.final_params)),
              f"{name}: non-finite params")
        arm["ps_mb"] = sum(led.bits[h] for h in PS_HOPS) / 8 / 1e6
        if name.startswith("Fed-CHS"):
            check(arm["ps_mb"] == 0, f"{name}: PS traffic")
        print(f"phase 3e: {name}: {arm['rounds']} rounds, {arm['s_per_round']:.3f} s/round "
              f"(evals included), peak memory {arm['peak_gb']:.2f} GB; launches "
              f"{ {k: v for k, v in arm['launches'].items() if v} }, expected {kernels} of "
              f"each packed kernel; ledger at the closed form {want}")
    print(f"phase 3e: LeNet-MNIST, Dirichlet(0.6), {n} clients, {M} ES, K={K}, E={E} "
          f"(Fed-CHS QSGD(16): phase 3a's {MAIN_ROUNDS}-round run, its s/round from 3a's warm "
          f"unprofiled 2-round run; WRWGD {WALK_ROUNDS} walk rounds; the others {R} rounds)")
    print(f"  {'algorithm':24s} {'rounds':>6s} {'s/round':>8s} {'peak GB':>8s} "
          f"{'final_acc':>9s} {'total_MB':>9s} {'PS traffic MB':>14s}")
    for arm in arms:
        res = arm["res"]
        print(f"  {arm['name']:24s} {arm['rounds']:6d} {arm['s_per_round']:8.3f} "
              f"{arm['peak_gb']:8.2f} {res.final_acc():9.4f} "
              f"{res.ledger.total_megabytes():9.1f} {arm['ps_mb']:14.1f}")
    return arms


def first_step_gaps(torch, task, params):
    """The MLP's first local step on every client's first batch, computed as
    the engine computes it (all clients under one `vmap`, params stacked),
    on the card and on the CPU: (hidden pre-activations whose sign differs,
    largest gradient gap over the largest gradient, over all leaves)."""
    from torch.func import grad, vmap

    from repro_torch.utils import tree_leaves, tree_map

    task.reset_loaders(0)
    n = task.num_clients
    batch = {k: torch.stack([task.sample_client_batches(i, 1)[k][0] for i in range(n)])
             for k in ("x", "y")}

    def pre(p, x):
        h, zs = x.reshape(x.shape[0], -1), []
        for layer in ("fc1", "fc2"):
            zs.append(h @ p[layer]["w"] + p[layer]["b"])
            h = torch.relu(zs[-1])
        return zs

    z, g = {}, {}
    for dev in ("cpu", "cuda"):
        stacked = tree_map(lambda a: a.to(dev).expand((n,) + a.shape), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        z[dev] = [t.cpu() for t in vmap(pre)(stacked, b["x"])]
        g[dev] = [t.cpu() for t in tree_leaves(vmap(grad(task.fed_model.loss))(stacked, b))]
    flips = sum(int(((a > 0) != (c > 0)).sum()) for a, c in zip(z["cpu"], z["cuda"]))
    gap = max(float((a - c).abs().max() / a.abs().max()) for a, c in zip(g["cpu"], g["cuda"]))
    return flips, gap


@dataclasses.dataclass(frozen=True)
class _AdamWWithoutBiasCorrection:
    """Phase 3f's control: AdamW's moments, no bias corrections."""

    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params):
        from repro_torch.optim.adamw import adamw_init

        return adamw_init(params)

    def step(self, params, state, grads, lr):
        from repro_torch.utils import tree_map

        mu = tree_map(lambda m, g: self.b1 * m + (1 - self.b1) * g, state["mu"], grads)
        nu = tree_map(lambda v, g: self.b2 * v + (1 - self.b2) * g * g, state["nu"], grads)
        new = tree_map(lambda p, m, v: p - lr * (m / (v.sqrt() + self.eps)
                                                 + self.weight_decay * p), params, mu, nu)
        return new, {"mu": mu, "nu": nu, "count": state["count"] + 1}


def baselines_cross_check(torch):
    """Phase 3f: the new code, card against CPU.  A small Hier-Local-QSGD
    QSGD(16) MLP run (20 clients in 3 uneven clusters, MomentumSGD) held to
    params within 3% relative L2, beside two CPU controls that bound must
    reject: no update, and dense uplinks.  Its accuracy and its gap over the
    update are printed, not bounded, beside what the same CPU run reads
    against itself with every initial weight scaled by 1 + 2^-23 (about an
    ulp): code flips under momentum make float order alone move this run
    further than phase 3a's tighter bounds allow.  A dense FedAvg run with
    AdamW held to ADAM_BOUND of its update (see there), beside a CPU control
    without AdamW's bias corrections and the same noise floor."""
    from repro_torch.core.baselines import (
        FedAvgConfig,
        HierLocalQSGDConfig,
        run_fedavg,
        run_hier_local_qsgd,
    )
    from repro_torch.core.simulation import FLTask
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.models.classifier import make_classifier
    from repro_torch.optim.local import AdamWOpt, MomentumSGD
    from repro_torch.utils import tree_map

    ds = make_dataset("mnist", train_size=4000, test_size=1000, seed=0)
    clients = dirichlet_partition(ds.train_y, 20, 0.6, seed=0)
    clusters = [list(range(0, 9)), list(range(9, 15)), list(range(15, 20))]
    mlp = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)

    def both(run, cfg, ctrl_cfg):
        on_card = run(FLTask(mlp, ds, clients, clusters, batch_size=32, seed=0), cfg)
        cpu_task = FLTask(mlp, ds, clients, clusters, batch_size=32, seed=0, device="cpu")
        p0 = cpu_task.init_params()
        on_cpu = run(cpu_task, cfg)
        return on_card, on_cpu, run(cpu_task, ctrl_cfg), p0

    hier = HierLocalQSGDConfig(rounds=2, local_steps=10, local_epochs=5, eval_every=1,
                               qsgd_levels=16, local_opt=MomentumSGD(0.9))
    on_card, on_cpu, dense, p0 = both(run_hier_local_qsgd, hier,
                                      dataclasses.replace(hier, qsgd_levels=None))
    rel, upd_rel, upd, gap = card_vs_cpu(torch, on_card, on_cpu, p0)
    b = flat_params(torch, on_cpu.final_params)
    ctrl_rel = float((flat_params(torch, dense.final_params) - b).norm() / b.norm())
    nudged = dataclasses.replace(mlp, init=lambda seed=0, device=None: tree_map(
        lambda t: t * (1 + 2**-23), mlp.init(seed, device)))
    ulp_run = run_hier_local_qsgd(
        FLTask(nudged, ds, clients, clusters, batch_size=32, seed=0, device="cpu"), hier)
    ulp_rel, ulp_upd_rel, _, ulp_gap = card_vs_cpu(torch, ulp_run, on_cpu, p0)
    print(f"phase 3f: Hier-Local-QSGD QSGD(16) MLP, MomentumSGD(0.9), 20 clients in clusters "
          f"of 9, 6, 5, 2 rounds, card vs CPU plain path: params rel L2 {rel:.3g} ({upd_rel:.3g} "
          f"of the update p_T - p_0), accuracy gap {gap:.3g}; the CPU run against itself from "
          f"weights 1 + 2^-23 apart: {ulp_rel:.3g} ({ulp_upd_rel:.3g} of the update), accuracy "
          f"gap {ulp_gap:.3g}; controls on the CPU: no update reads {upd:.3g}, dense uplinks "
          f"read {ctrl_rel:.3g}")
    check(rel <= 0.03, "card Hier-Local-QSGD run strays from the CPU run")
    check(upd > 0.03, "the params bound would pass a Hier-Local-QSGD run that never updates")
    check(ctrl_rel > 0.03, "the params bound would pass a run whose uplinks skip the quantizer")

    fedavg = FedAvgConfig(rounds=2, local_steps=5, eval_every=1, local_opt=AdamWOpt(),
                          schedule=lambda k: 0.002)
    on_card, on_cpu, ctrl, p0 = both(
        run_fedavg, fedavg, dataclasses.replace(fedavg, local_opt=_AdamWWithoutBiasCorrection()))
    _, upd_rel, upd, gap = card_vs_cpu(torch, on_card, on_cpu, p0)
    _, ctrl_rel, _, _ = card_vs_cpu(torch, ctrl, on_cpu, p0)
    ulp_run = run_fedavg(
        FLTask(nudged, ds, clients, clusters, batch_size=32, seed=0, device="cpu"), fedavg)
    _, ulp_upd_rel, _, _ = card_vs_cpu(torch, ulp_run, on_cpu, p0)
    cpu_task = FLTask(mlp, ds, clients, clusters, batch_size=32, seed=0, device="cpu")
    flips, grad_gap = first_step_gaps(torch, cpu_task, cpu_task.init_params())
    print(f"  FedAvg dense, AdamW, 2 rounds, card vs CPU plain path: params gap {upd_rel:.3g} "
          f"of the update p_T - p_0 (which is {upd:.3g} of p_T; bound {ADAM_BOUND:g}), accuracy "
          f"gap {gap:.3g}; the CPU run against itself from weights 1 + 2^-23 apart: "
          f"{ulp_upd_rel:.3g}; first local step on the card vs the CPU: {flips} hidden "
          f"pre-activations of opposite sign (of 20 clients x 32 samples x 400 units), "
          f"gradients apart by {grad_gap:.3g} of the largest; control on the CPU without "
          f"AdamW's bias corrections reads {ctrl_rel:.3g}")
    check(upd_rel <= ADAM_BOUND, "card FedAvg AdamW run strays from the CPU run")
    check(ctrl_rel > ADAM_BOUND, "the bound would pass AdamW without bias corrections")


CHURN_ROUNDS, HIER_CHURN_ROUNDS, DYN_ROUNDS = 6, 2, 4  # phase 3g's cuts of 200 rounds


class _DarkRounds:
    """Phase 3g's pass-through arm: `inner`'s participants, but nobody in
    the `dark` rounds."""

    def __init__(self, inner, dark):
        self.inner, self.dark = inner, set(dark)

    def participants(self, round_idx, clients):
        return [] if round_idx in self.dark else self.inner.participants(round_idx, clients)


def churn_ledger_checks(name, res, task, sampler, channel, J):
    """A Fed-CHS run under `sampler`: each round's uplinks are exactly J per
    participant of the visited cluster, every message at the closed form.
    Returns (visit order, trained rounds)."""
    from repro_torch.comm.channels import DenseChannel, channel_wire_bits

    leaf_sizes = task.param_leaf_sizes()
    d = sum(leaf_sizes)
    up, down = channel_wire_bits(channel, d, leaf_sizes), DenseChannel().message_bits(d)
    led = res.ledger
    hops = [e for e in led.events if e.hop == "es_to_es"]
    visits = [int(hops[0].sender.split(":")[1])] + [int(e.receiver.split(":")[1]) for e in hops]
    trained, n_up = [], 0
    for t, events in sorted(led.round_events().items()):
        parts = sampler.participants(t, task.cluster_members[visits[t]])
        ups = sorted((e.phase, e.sender, e.n_bits) for e in events if e.hop == "client_to_es")
        want = sorted((j, f"client:{i}", up) for j in range(J) for i in parts)
        check(ups == want, f"{name}: round {t}'s uplinks differ from J per participant")
        downs = sum(1 for e in events if e.hop == "es_to_client" and e.n_bits == down)
        check(downs == len(want), f"{name}: round {t}'s broadcasts differ from its uplinks")
        if parts:
            trained.append(t)
        n_up += len(want)
    want = {"client_to_es": (n_up, n_up * up), "es_to_client": (n_up, n_up * down),
            "es_to_es": (len(hops), len(hops) * down)}
    got = {h: (led.messages[h], led.bits[h]) for h in led.messages if led.messages[h]}
    check(got == want, f"{name}: ledger {got} differs from the closed form {want}")
    return visits[:-1], trained


def participation_path(torch, build, task, arms):
    """Phase 3g: partial participation, dynamic ES graphs and the netsim
    replay, at the Appendix-A scale of phases 3a and 3e.  Fed-CHS QSGD(16)
    under Gilbert-Elliott churn without and with the availability-aware
    rule, then with two forced dark rounds (pass-throughs that must launch
    nothing, send nothing and leave the params bit-equal); Hier-Local-QSGD
    QSGD(16) on both hops under Bernoulli churn; Fed-CHS on the IoV and LEO
    graphs, whose visit order must be the scheduler's own replay; a small
    masked MLP run on the card against the CPU's plain path; and every arm
    of 3e and 3g replayed through netsim's edge-cloud network."""
    from repro_torch.comm.channels import DenseChannel, QSGDChannel, channel_wire_bits
    from repro_torch.core.baselines import HierLocalQSGDConfig, run_hier_local_qsgd
    from repro_torch.core.dynamics import make_dynamic
    from repro_torch.core.fed_chs import FedCHSConfig, _make_scheduler, run_fed_chs
    from repro_torch.core.scheduler import FedCHSScheduler
    from repro_torch.core.topology import make_topology
    from repro_torch.netsim import edge_cloud_network, simulate_run
    from repro_torch.part import AvailabilityAware, BernoulliTrace, GilbertElliottTrace
    from repro_torch.utils import tree_leaves

    K, E = MAIN_K, MAIN_E
    J, M = K // E, task.num_clusters
    leaf_sizes = task.param_leaf_sizes()
    L, d = len(leaf_sizes), sum(leaf_sizes)
    qsgd16 = QSGDChannel(16)
    packed = ("qsgd_quantize_pack", "qsgd_unpack_dequantize")

    def churn():  # examples/participation_tour.py's trace
        return AvailabilityAware(GilbertElliottTrace(p_fail=0.25, p_recover=0.35, seed=5))

    def chs_cfg(rounds, **kw):
        return FedCHSConfig(rounds=rounds, local_steps=K, local_epochs=E, eval_every=2,
                            channel=qsgd16, seed=0, **kw)

    def check_launches(arm, want):
        for k, v in arm["launches"].items():
            check(v == (want if k in packed else 0),
                  f"{arm['name']}: {k} launched {v} times, expected {want if k in packed else 0}")

    def check_finite(arm):
        res = arm["res"]
        check(all(math.isfinite(x) for x in res.test_acc + res.train_loss),
              f"{arm['name']}: non-finite trace")
        check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(res.final_params)),
              f"{arm['name']}: non-finite params")

    new = []
    for name, sched in (("Fed-CHS QSGD(16), GE churn", False),
                        ("Fed-CHS QSGD(16), GE churn + availability rule", True)):
        cfg = chs_cfg(CHURN_ROUNDS, sampler=churn(), availability_scheduler=sched)
        arm = comparison_arm(torch, build, name, lambda cfg=cfg: run_fed_chs(task, cfg),
                             CHURN_ROUNDS)
        visits, trained = churn_ledger_checks(name, arm["res"], task, cfg.sampler, qsgd16, J)
        check_launches(arm, len(trained) * J * L)
        check_finite(arm)
        topo = make_topology(cfg.topology, M, seed=cfg.topology_seed)
        replay = _make_scheduler(task, cfg, topo, visits[0]).precompute(CHURN_ROUNDS)
        check(visits == list(replay), f"{name}: visit order {visits} is not the rule's {replay}")
        passes = CHURN_ROUNDS - len(trained)
        if sched:
            check(passes == 0, f"{name}: {passes} pass-through rounds under the availability rule")
        print(f"phase 3g: {name}: {CHURN_ROUNDS} rounds, {arm['s_per_round']:.3f} s/round, peak "
              f"{arm['peak_gb']:.2f} GB; visits {visits} (the rule's replay); pass-through "
              f"rounds {passes}; uplinks {arm['res'].ledger.messages['client_to_es']} "
              f"(of {CHURN_ROUNDS * J * task.num_clients // M} at full participation), each "
              f"J per participant; launches {arm['launches']}, expected {len(trained) * J * L} "
              f"of each packed kernel; accuracy {arm['res'].test_acc}")
        new.append(arm)

    # forced pass-throughs: rounds 1 and 2 dark, everything else as under churn
    dark = _DarkRounds(churn(), {1, 2})
    name = "Fed-CHS QSGD(16), dark rounds 1-2"
    arm = comparison_arm(torch, build, name, lambda: run_fed_chs(
        task, chs_cfg(4, sampler=dark)), 4)
    visits, trained = churn_ledger_checks(name, arm["res"], task, dark, qsgd16, J)
    check(trained == [0, 3], f"{name}: trained rounds {trained}")
    check_launches(arm, 2 * J * L)
    check_finite(arm)
    before = run_fed_chs(task, chs_cfg(1, sampler=dark)).final_params
    after = run_fed_chs(task, chs_cfg(3, sampler=dark)).final_params
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(before), tree_leaves(after))),
          "the pass-through rounds 1-2 moved the params")
    print(f"phase 3g: {name}: launches {arm['launches']}, expected {2 * J * L} (rounds 0 and 3 "
          f"only); rounds 1-2 carry only their ES->ES hop, and the params after round 2 equal "
          f"those after round 0 bit for bit")
    new.append(arm)

    name = "Hier-Local-QSGD QSGD(16), Bernoulli(0.7)"
    bern = AvailabilityAware(BernoulliTrace(p=0.7))
    R = HIER_CHURN_ROUNDS
    arm = comparison_arm(torch, build, name, lambda: run_hier_local_qsgd(task, HierLocalQSGDConfig(
        rounds=R, local_steps=K, local_epochs=E, eval_every=1, qsgd_levels=16, sampler=bern)), R)
    check_launches(arm, R * (J * L + L))
    check_finite(arm)
    up, down = channel_wire_bits(qsgd16, d, leaf_sizes), DenseChannel().message_bits(d)
    led = arm["res"].ledger
    for t in range(R):
        parts = [bern.participants(t, members) for members in task.cluster_members]
        events = led.round_events()[t]
        ups = sorted((e.phase, e.sender, e.receiver) for e in events if e.hop == "client_to_es")
        check(ups == sorted((j, f"client:{i}", f"es:{m}") for j in range(J)
                            for m in range(M) for i in parts[m]),
              f"{name}: round {t}'s uplinks differ from J per participant")
        check(sorted(e.sender for e in events if e.hop == "es_to_ps")
              == sorted(f"es:{m}" for m in range(M) if parts[m]),
              f"{name}: round {t}: es_to_ps from clusters that did not train")
        check(sorted(e.receiver for e in events if e.hop == "ps_to_es")
              == sorted(f"es:{m}" for m in range(M)), f"{name}: round {t}: ps_to_es not to all")
    n_up = led.messages["client_to_es"]
    n_es = sum(1 for t in range(R) for m in task.cluster_members
               if bern.participants(t, m))
    want = {"client_to_es": (n_up, n_up * up), "es_to_client": (n_up, n_up * down),
            "es_to_ps": (n_es, n_es * up), "ps_to_es": (R * M, R * M * down)}
    got = {h: (led.messages[h], led.bits[h]) for h in led.messages if led.messages[h]}
    check(got == want, f"{name}: ledger {got} differs from the closed form {want}")
    print(f"phase 3g: {name}: {R} rounds, {arm['s_per_round']:.3f} s/round, peak "
          f"{arm['peak_gb']:.2f} GB; launches {arm['launches']}, expected {R * (J * L + L)}; "
          f"uplinks {n_up} of {R * J * task.num_clients}, es_to_ps {n_es}, ps_to_es {R * M}")
    new.append(arm)

    for kind in ("iov", "leo"):
        name = f"Fed-CHS QSGD(16), dynamic {kind}"
        cfg = chs_cfg(DYN_ROUNDS, dynamic=kind)
        arm = comparison_arm(torch, build, name, lambda cfg=cfg: run_fed_chs(task, cfg),
                             DYN_ROUNDS)
        check_launches(arm, DYN_ROUNDS * J * L)
        check_finite(arm)
        visits, trained = churn_ledger_checks(name, arm["res"], task,
                                              AvailabilityAware(), qsgd16, J)
        dyn = make_dynamic(kind, M, seed=cfg.topology_seed)
        replay = FedCHSScheduler(dyn(0), task.cluster_sizes, initial=visits[0]).precompute(
            DYN_ROUNDS + 1, dynamic=dyn)
        hops = [int(e.receiver.split(":")[1]) for e in arm["res"].ledger.events
                if e.hop == "es_to_es"]
        check(visits + hops[-1:] == list(replay),
              f"{name}: visit order {visits + hops[-1:]} is not precompute's {list(replay)}")
        print(f"phase 3g: {name}: {DYN_ROUNDS} rounds, {arm['s_per_round']:.3f} s/round; "
              f"visits {visits + hops[-1:]} = precompute(dynamic={kind!r}); launches "
              f"{arm['launches']}")
        new.append(arm)

    masked_cross_check(torch)

    net = edge_cloud_network(seed=0)
    print("phase 3g: netsim replay under edge_cloud_network(seed=0), simulated seconds:")
    for arm in arms + new:
        res = arm["res"]
        tl = simulate_run(task, res, net, local_steps=K)
        rounds = res.rounds[-1] + 1
        check(math.isfinite(tl.makespan) and tl.makespan > 0, f"{arm['name']}: netsim makespan")
        print(f"  {arm['name']:48s} {rounds:3d} rounds, {tl.makespan / rounds:10.3f} s/round, "
              f"makespan {tl.makespan:10.3f} s")
    return new


def masked_cross_check(torch):
    """Phase 3g, continued: a masked MLP QSGD(16) Fed-CHS run under churn on
    the card against the same run on the CPU's plain path, at phase 3a's
    bound, beside what the CPU run reads against itself from weights
    1 + 2^-23 apart."""
    from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
    from repro_torch.core.simulation import FLTask
    from repro_torch.data.partition import assign_clusters, dirichlet_partition
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.models.classifier import make_classifier
    from repro_torch.part import AvailabilityAware, GilbertElliottTrace
    from repro_torch.utils import tree_map

    ds = make_dataset("mnist", train_size=4000, test_size=1000, seed=0)
    clients = dirichlet_partition(ds.train_y, 20, 0.6, seed=0)
    clusters = assign_clusters(20, 4, seed=0)
    mlp = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    cfg = FedCHSConfig(rounds=4, local_steps=10, local_epochs=5, eval_every=2, qsgd_levels=16,
                       sampler=AvailabilityAware(GilbertElliottTrace(0.25, 0.35, seed=5)))
    on_card = run_fed_chs(FLTask(mlp, ds, clients, clusters, batch_size=32, seed=0), cfg)
    cpu_task = FLTask(mlp, ds, clients, clusters, batch_size=32, seed=0, device="cpu")
    p0 = cpu_task.init_params()
    on_cpu = run_fed_chs(cpu_task, cfg)
    rel, upd_rel, upd, gap = card_vs_cpu(torch, on_card, on_cpu, p0)
    nudged = dataclasses.replace(mlp, init=lambda seed=0, device=None: tree_map(
        lambda t: t * (1 + 2**-23), mlp.init(seed, device)))
    ulp_run = run_fed_chs(FLTask(nudged, ds, clients, clusters, batch_size=32, seed=0,
                                 device="cpu"), cfg)
    ulp_rel, ulp_upd_rel, _, ulp_gap = card_vs_cpu(torch, ulp_run, on_cpu, p0)
    ups = on_cpu.ledger.messages["client_to_es"]
    print(f"phase 3g: masked MLP QSGD(16) run under GE churn ({ups} uplinks of "
          f"{4 * 2 * 5} at full participation), card vs CPU plain path: params rel L2 "
          f"{rel:.3g} ({upd_rel:.3g} of the update p_T - p_0, which is {upd:.3g} of p_T), "
          f"accuracy gap {gap:.3g}; the CPU run against itself from weights 1 + 2^-23 apart: "
          f"{ulp_rel:.3g} ({ulp_upd_rel:.3g} of the update), accuracy gap {ulp_gap:.3g}")
    check(rel <= 0.03 and upd_rel <= 0.03 and gap <= 0.02,
          "card masked run strays from the CPU run")


# phase 3h: the memory-lean engine.  The LM arms train one client at a time
# (client_microbatch 1) for LEAN_ROUNDS rounds: 3b's 3 do not show the
# QSGD(16) arm's loss falling under bf16 compute (an H100 80GB HBM3 at 700 W
# read 12.4355, 12.4186, 12.4412, then 12.4034, 12.4197, 12.3727); the
# Appendix-A arms at 3e's scale keep 2 and 10 client replicas live.  A
# card-vs-CPU gap under bf16 compute is bounded by CROSS_ULPS times the CPU
# run's own gap from weights 1 bf16 ulp apart.
LEAN_MB, LEAN_ROUNDS = 1, 6
MB_ARMS = (("Hier-Local-QSGD QSGD(16)", 2), ("FedAvg", 10))
CROSS_ULPS = 2.0
BF16_ULP = 2.0**-7


def lean_lm_path(torch, build, f32_peak_gb, f32_round_s):
    """Phase 3h-LM: qwen3-0.6b at full width and depth (f32 master) under
    `Precision()`, `client_microbatch=1` and `LMFedModel(remat=True,
    flash=True)`, with the bf16 dense wire and with QSGD(16) uplinks,
    LEAN_ROUNDS rounds each; then
    one warm round, unprofiled and profiled; then the peak memory of one
    round with remat off and on at client_microbatch 2 and 1, in bf16 and
    in f32."""
    from repro_torch.comm.channels import QSGDChannel, channel_wire_bits
    from repro_torch.configs.registry import get_config
    from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
    from repro_torch.core.precision import Precision, resolve_channel
    from repro_torch.utils import tree_leaves

    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    source_kw = dict(num_clients=LM_CLIENTS, batch_size=LM_BATCH, seq_len=LM_SEQ)
    task = lm_task(cfg, remat=True, **source_kw)
    policy = Precision()
    J, n = LM_K // LM_E, len(LM_CLUSTERS[0])
    groups = math.ceil(n / LEAN_MB)
    n_eval_batches = len(task.source.eval_data()["tokens"])
    for name, channel in (("bf16 dense wire", None), ("QSGD(16)", QSGDChannel(16))):
        config = FedCHSConfig(rounds=LEAN_ROUNDS, local_steps=LM_K, local_epochs=LM_E,
                              eval_every=1, channel=channel, seed=0,
                              schedule=lambda k: LM_LR, client_microbatch=LEAN_MB,
                              precision=policy)
        arm = comparison_arm(torch, build, name, lambda: run_fed_chs(task, config), LEAN_ROUNDS)
        res, launches, led = arm["res"], arm["launches"], arm["res"].ledger
        leaf_sizes = [t.numel() for t in tree_leaves(res.final_params)]
        L, d = len(leaf_sizes), sum(leaf_sizes)
        evals = len(res.rounds)
        packed = LEAN_ROUNDS * J * groups * L if channel is not None else 0
        want = {"flash_attention": cfg.num_layers * (LEAN_ROUNDS * LM_K * groups * 2
                                                     + evals * n_eval_batches),
                "qsgd_quantize_pack": packed, "qsgd_unpack_dequantize": packed,
                "qsgd_quantize": 0, "qsgd_dequantize": 0}
        print(f"phase 3h: {LM_ARCH} Fed-CHS, {name}, Precision() (bf16 compute, f32 master, "
              f"bf16 broadcasts), client_microbatch={LEAN_MB}, remat, flash: {d} params in "
              f"{L} leaves; {LEAN_ROUNDS} rounds, {arm['s_per_round']:.3f} s/round ({evals} "
              f"evals of {n_eval_batches} batches included; phase 3b f32: "
              f"{f32_round_s:.3f} s for a warm round); peak memory {arm['peak_gb']:.2f} GB "
              f"(phase 3b f32: {f32_peak_gb:.2f} GB)")
        print(f"  launches {launches}, expected {want} (flash: layers x (rounds x K x "
              f"{groups} groups x 2, forward and recompute, + evals x eval batches))")
        check(L == LM_LEAVES and d == LM_PARAMS, f"{L} leaves / {d} params")
        for k, v in want.items():
            check(launches[k] == v, f"{name}: {k} launched {launches[k]} times, expected {v}")
        up = channel_wire_bits(resolve_channel(policy, channel), d, leaf_sizes)
        down = 16 * d
        visited = [int(e.sender.split(":")[1]) for e in led.events if e.hop == "es_to_es"]
        n_up = sum(J * len(LM_CLUSTERS[m]) for m in visited)
        want_led = {"client_to_es": (n_up, up), "es_to_client": (n_up, down),
                    "es_to_es": (LEAN_ROUNDS, down)}
        got = {h: (led.messages[h], led.bits[h]) for h in led.messages if led.messages[h]}
        check(got == {h: (m, m * b) for h, (m, b) in want_led.items()},
              f"{name}: ledger {got} differs from the closed form {want_led}")
        if channel is None:
            check(2 * up == 32 * d, "the bf16 dense uplink is not half the f32 message")
        else:
            check(up == channel_wire_bits(QSGDChannel(16), d, leaf_sizes), "QSGD uplink bits")
        print(f"  ledger at the closed form {want_led} (uplink {up} bits/message, "
              f"{32 * d / up:.2f}x under f32; broadcasts at 16 bits/param)")
        print(f"  perplexity {res.test_acc} at rounds {res.rounds}; train loss {res.train_loss}")
        check(all(math.isfinite(x) for x in res.test_acc + res.train_loss),
              f"{name}: non-finite LM trace")
        check(res.train_loss[-1] < res.train_loss[0], f"{name}: the train loss did not fall")
        check(res.test_acc[-1] < res.test_acc[0], f"{name}: the perplexity did not fall")
        check(all(t.dtype == torch.float32 and bool(torch.isfinite(t).all())
                  for t in tree_leaves(res.final_params)), f"{name}: params not finite f32")
        del arm, res

    one = FedCHSConfig(rounds=1, local_steps=LM_K, local_epochs=LM_E, eval_every=1, seed=0,
                       schedule=lambda k: LM_LR, client_microbatch=LEAN_MB, precision=policy)
    _, plain_ms = timed(torch, lambda: run_fed_chs(task, one))
    _, wall_ms, events = profiled(torch, lambda: run_fed_chs(task, one))
    print(f"  one warm round, bf16 dense wire (K={LM_K} steps of {groups} client groups, an "
          f"eval of {n_eval_batches} batches), unprofiled then profiled:")
    print_profile(wall_ms, plain_ms, events, 12)
    print_gemm_share(events, plain_ms)
    del task

    print("  peak memory of one round by knob (GB; 2 clients per cluster, so "
          "client_microbatch 2 trains the cluster in one vmap):")
    for label, prec, channel in (("bf16 compute, bf16 wire", policy, None),
                                 ("f32, QSGD(16) as 3b", None, QSGDChannel(16))):
        row = []
        for remat, mb in ((False, 2), (True, 2), (False, 1), (True, 1)):
            knob_task = lm_task(cfg, remat=remat, **source_kw)
            knob = FedCHSConfig(rounds=1, local_steps=LM_K, local_epochs=LM_E, eval_every=1,
                                channel=channel, seed=0, schedule=lambda k: LM_LR,
                                client_microbatch=mb, precision=prec)
            arm = comparison_arm(torch, build, label, lambda: run_fed_chs(knob_task, knob), 1)
            row.append(f"remat {'on' if remat else 'off'}, mb {mb}: {arm['peak_gb']:.2f} "
                       f"({arm['s_per_round']:.3f} s)")
            del arm, knob_task
        print(f"    {label}: " + "; ".join(row))


def lean_cross_check(torch):
    """Phase 3h-cross: the lean knobs, card against CPU.  The 2-layer
    smoke-config LM of phase 3d (bf16 dense wire, client_microbatch 1,
    remat, flash) and phase 3a's MLP QSGD(16) task (client_microbatch 2)
    under `Precision()`.  Each gap over the update p_T - p_0 is bounded by
    CROSS_ULPS times the CPU run's own gap from initial weights scaled by
    1 + 2^-7 (one bf16 ulp), printed beside it; each bound must reject a
    run that never updates (which reads 1) and a CPU control: a 16-key
    window in place of causal attention for the LM, a doubled step size for
    the MLP."""
    from repro_torch.comm.channels import QSGDChannel
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
    from repro_torch.core.precision import Precision
    from repro_torch.core.simulation import FLTask
    from repro_torch.data.partition import assign_clusters, dirichlet_partition
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.models.classifier import make_classifier
    from repro_torch.optim.schedules import paper_sqrt_schedule
    from repro_torch.utils import tree_map

    def bounded(name, on_card, on_cpu, ulp_run, ctrl, ctrl_name, p0):
        _, upd_rel, upd, gap = card_vs_cpu(torch, on_card, on_cpu, p0)
        _, ulp_rel, _, _ = card_vs_cpu(torch, ulp_run, on_cpu, p0)
        _, ctrl_rel, _, _ = card_vs_cpu(torch, ctrl, on_cpu, p0)
        bound = CROSS_ULPS * ulp_rel
        print(f"phase 3h: {name}, card vs CPU plain path: params gap {upd_rel:.3g} of the update "
              f"p_T - p_0 (which is {upd:.3g} of p_T), largest metric gap {gap:.3g} (accuracy or "
              f"perplexity, absolute); the CPU run against "
              f"itself from weights 1 + 2^-7 apart: {ulp_rel:.3g}, so the bound is {bound:.3g}; "
              f"controls: no update reads 1, {ctrl_name} reads {ctrl_rel:.3g}")
        check(upd_rel <= bound, f"{name}: the card run strays from the CPU run")
        check(bound < 1.0, f"{name}: the bound would pass a run that never updates")
        check(ctrl_rel > bound, f"{name}: the bound would pass the {ctrl_name} control")

    policy = Precision()
    cfg = smoke_config(LM_ARCH)
    kw = dict(num_clients=4, batch_size=2, seq_len=64)
    config = FedCHSConfig(rounds=2, local_steps=4, local_epochs=2, eval_every=1, seed=0,
                          schedule=lambda k: 0.3, client_microbatch=LEAN_MB, precision=policy)
    cpu = dict(device="cpu", init_on_cpu=True, remat=True)
    on_card = run_fed_chs(lm_task(cfg, init_on_cpu=True, remat=True, **kw), config)
    cpu_task = lm_task(cfg, **cpu, **kw)
    p0 = cpu_task.init_params()
    on_cpu = run_fed_chs(cpu_task, config)
    ulp_run = run_fed_chs(lm_task(cfg, scale=1 + BF16_ULP, **cpu, **kw), config)
    wrong = dataclasses.replace(cfg, block_pattern=("local",), sliding_window=16)
    ctrl = run_fed_chs(lm_task(wrong, **cpu, **kw), config)
    bounded(f"{LM_ARCH} smoke-config LM (2 layers), bf16 dense wire, client_microbatch "
            f"{LEAN_MB}, remat, flash, 2 rounds", on_card, on_cpu, ulp_run, ctrl,
            "the window-16 mask", p0)

    ds = make_dataset("mnist", train_size=4000, test_size=1000, seed=0)
    clients = dirichlet_partition(ds.train_y, 20, 0.6, seed=0)
    clusters = assign_clusters(20, 4, seed=0)
    mlp = make_classifier("mlp", "mnist", ds.spec.image_shape, 10)
    nudged = dataclasses.replace(mlp, init=lambda seed=0, device=None: tree_map(
        lambda t: t * (1 + BF16_ULP), mlp.init(seed, device)))
    mlp_cfg = FedCHSConfig(rounds=4, local_steps=10, local_epochs=5, eval_every=2,
                           channel=QSGDChannel(16), precision=policy, client_microbatch=2)
    eta = paper_sqrt_schedule(10, half=False)

    def task(model, device=None):
        return FLTask(model, ds, clients, clusters, batch_size=32, seed=0, device=device)

    on_card = run_fed_chs(task(mlp), mlp_cfg)
    cpu_task = task(mlp, "cpu")
    p0 = cpu_task.init_params()
    on_cpu = run_fed_chs(cpu_task, mlp_cfg)
    ulp_run = run_fed_chs(task(nudged, "cpu"), mlp_cfg)
    ctrl = run_fed_chs(cpu_task, dataclasses.replace(mlp_cfg, schedule=lambda k: 2 * eta(k)))
    bounded("MLP QSGD(16) (phase 3a's task), client_microbatch 2, 4 rounds", on_card, on_cpu,
            ulp_run, ctrl, "the doubled step size", p0)


def microbatched_appendix_arms(torch, build, task, arms):
    """Phase 3h-mem: Hier-Local-QSGD QSGD(16) at client_microbatch 2 and
    FedAvg at 10, at phase 3e's scale and config: ledgers bit for bit equal
    to 3e's, B1 and B2 once per leaf per group of every cluster (and once
    per leaf at the ES hop), peak memory and s/round beside 3e's."""
    from repro_torch.core.baselines import (
        FedAvgConfig,
        HierLocalQSGDConfig,
        run_fedavg,
        run_hier_local_qsgd,
    )

    R, K, E = COMPARE_ROUNDS, MAIN_K, MAIN_E
    J, L = K // E, len(task.param_leaf_sizes())
    n_max = max(len(m) for m in task.cluster_members)
    runs = {"Hier-Local-QSGD QSGD(16)": lambda mb: run_hier_local_qsgd(task, HierLocalQSGDConfig(
                rounds=R, local_steps=K, local_epochs=E, eval_every=1, qsgd_levels=16,
                client_microbatch=mb)),
            "FedAvg": lambda mb: run_fedavg(task, FedAvgConfig(
                rounds=R, local_steps=K, eval_every=1, client_microbatch=mb))}
    packed = ("qsgd_quantize_pack", "qsgd_unpack_dequantize")
    for name, mb in MB_ARMS:
        hier = name.startswith("Hier")
        width = n_max if hier else task.num_clients  # the client axis the groups split
        base = next(a for a in arms if a["name"] == name)
        arm = comparison_arm(torch, build, name, lambda: runs[name](mb), R)
        res, led, bled = arm["res"], arm["res"].ledger, base["res"].ledger
        nonzero = lambda counts: {h: v for h, v in counts.items() if v}  # noqa: E731
        check(led.events == bled.events and led.history == bled.history
              and nonzero(led.bits) == nonzero(bled.bits)
              and nonzero(led.messages) == nonzero(bled.messages),
              f"{name}, client_microbatch {mb}: the ledger differs from phase 3e's")
        kernels = R * (J * math.ceil(width / mb) * L + L) if hier else 0
        for k, v in arm["launches"].items():
            want = kernels if k in packed else 0
            check(v == want, f"{name}, client_microbatch {mb}: {k} launched {v}, expected {want}")
        a, b = flat_params(torch, res.final_params), flat_params(torch, base["res"].final_params)
        print(f"phase 3h: {name}, client_microbatch={mb} ({math.ceil(width / mb)} groups of "
              f"{width} client slots): {R} rounds, {arm['s_per_round']:.3f} s/round, peak memory "
              f"{arm['peak_gb']:.2f} GB (phase 3e, all clients at once: "
              f"{base['s_per_round']:.3f} s/round, {base['peak_gb']:.2f} GB); ledger equal to "
              f"3e's; launches { {k: v for k, v in arm['launches'].items() if v} }, expected "
              f"{kernels} of each packed kernel; params {float((a - b).norm() / b.norm()):.3g} "
              f"from 3e's in relative L2")


# phase 3i: the whole-run executor.  Every driver call above runs scanned
# (the default); 3i holds the scanned runs against the looped driver.
SWEEP_SEEDS, SWEEP_ROUNDS = (0, 1, 2), 3
PACKED_KERNELS = {"qsgd_quantize_pack": "quantize_pack", "qsgd_unpack_dequantize":
                  "unpack_dequantize"}  # wrapper -> a substring of its kernels' names


def params_gap(torch, a, b) -> float:
    """The largest entry-wise gap between two runs' final params."""
    from repro_torch.utils import tree_leaves

    return max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a.final_params),
                                                           tree_leaves(b.final_params)))


def same_run(torch, name, scanned, looped) -> None:
    """A scanned run against the looped run of the same config: params bit
    for bit, eval metric, ledger (bits, events, history) and visit order."""
    gap = params_gap(torch, scanned, looped)
    check(gap == 0.0, f"{name}: scanned params differ from the looped run's by up to {gap:.3g}")
    check(scanned.rounds == looped.rounds and scanned.test_acc == looped.test_acc,
          f"{name}: eval trace {scanned.test_acc} differs from the looped {looped.test_acc}")
    a, b = scanned.ledger, looped.ledger
    nonzero = lambda d: {h: v for h, v in d.items() if v}  # noqa: E731 (lookups add zeros)
    check(nonzero(a.bits) == nonzero(b.bits) and nonzero(a.messages) == nonzero(b.messages)
          and a.events == b.events and a.history == b.history,
          f"{name}: the scanned ledger differs from the looped one")


def executor_stats() -> str:
    """The last scanned run's warm-up round, capture and replays."""
    from repro_torch.core.engine import LAST_STATS as st

    return (f"warm-up round {st['warmup_s']:.3f} s, capture {st['capture_s']:.3f} s (host), "
            f"{st['replays']} replays")


def kernel_share(torch, run, label):
    """Profile `run()` and print its kernel time against the unprofiled wall
    of a second call.  Returns (result, kernel ms, profiled events)."""
    first, wall_ms, events = profiled(torch, run)
    _, plain_ms = timed(torch, run)
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    print(f"  {label}: wall {plain_ms:.1f} ms unprofiled ({wall_ms:.1f} profiled), kernel time "
          f"{busy_ms:.1f} ms = {100 * busy_ms / plain_ms:.1f}% of the unprofiled wall")
    return first, busy_ms, events, plain_ms


def scanned_appendix_path(torch, build, task, arms):
    """Phase 3i-a, c, d at the Appendix-A scale of 3a: Fed-CHS QSGD(16)
    scanned (one captured round replayed) against looped; the counter of
    the packed kernels against the profiler's count; the baselines' looped
    arms against 3e's scanned ones; a chunk under the sync debug mode
    "error"; `run_sweep` of 3 seeds against their solo runs."""
    from repro_torch.comm.channels import QSGDChannel
    from repro_torch.core import engine
    from repro_torch.core.baselines import run_fedavg, run_hier_local_qsgd, run_wrwgd
    from repro_torch.core.fed_chs import FedCHSConfig, _fed_chs_scan_plan, run_fed_chs
    from repro_torch.core.sweep import run_sweep

    import numpy as np

    leaf_sizes = task.param_leaf_sizes()
    L, J = len(leaf_sizes), MAIN_K // MAIN_E
    cfg = FedCHSConfig(rounds=MAIN_ROUNDS, local_steps=MAIN_K, local_epochs=MAIN_E,
                       eval_every=2, channel=QSGDChannel(16), seed=0)
    looped_cfg = dataclasses.replace(cfg, scan_rounds=False)
    scanned = comparison_arm(torch, build, "scanned", lambda: run_fed_chs(task, cfg), MAIN_ROUNDS)
    looped = comparison_arm(torch, build, "looped", lambda: run_fed_chs(task, looped_cfg),
                            MAIN_ROUNDS)
    same_run(torch, "3i-a Fed-CHS QSGD(16)", scanned["res"], looped["res"])
    want = MAIN_ROUNDS * J * L
    for arm in (scanned, looped):
        for k, v in arm["launches"].items():
            check(v == (want if k in PACKED_KERNELS else 0),
                  f"3i-a {arm['name']}: {k} launched {v} times, expected {want}")
    stats = executor_stats()
    print(f"phase 3i-a: LeNet-MNIST Fed-CHS QSGD(16), {MAIN_ROUNDS} rounds (evals at rounds "
          f"{scanned['res'].rounds}; {stats}): scanned {scanned['s_per_round']:.3f} s/round, "
          f"looped {looped['s_per_round']:.3f} s/round; params bit-equal, eval trace, ledger and visit "
          f"order equal; B1 = B2 = {want} = rounds x J x leaves from the executor's counter; "
          f"peak {scanned['peak_gb']:.2f} GB scanned, {looped['peak_gb']:.2f} looped")

    # the executor's counter against the profiler's count of kernels by name
    short = dataclasses.replace(cfg, rounds=3, eval_every=10**6)
    build.reset_launches()
    _, busy_s, events, wall_s = kernel_share(torch, lambda: run_fed_chs(task, short),
                                             "scanned, 3 rounds, evals at rounds 0 and 2")
    print(f"    the unprofiled run's executor: {executor_stats()}")
    counted = dict(build.LAUNCHES)  # two runs: profiled, then timed
    for name, key in PACKED_KERNELS.items():
        seen = sum(e.count for e in events if key in e.key)
        check(seen == counted[name] // 2 == 3 * J * L,
              f"{name}: the profiler saw {seen} kernels, the counter {counted[name] // 2}")
        print(f"  {name}: the profiler counts {seen} kernels named *{key}* in the scanned run, "
              f"the executor's counter {counted[name] // 2}")
    _, busy_l, _, wall_l = kernel_share(
        torch, lambda: run_fed_chs(task, dataclasses.replace(short, scan_rounds=False)),
        "looped, 3 rounds, evals at rounds 0 and 2")
    print(f"  warm 3-round runs: scanned {wall_s / 3e3:.3f} s/round, kernel share "
          f"{100 * busy_s / wall_s:.1f}%; looped {wall_l / 3e3:.3f} s/round, kernel share "
          f"{100 * busy_l / wall_l:.1f}%")

    # the baselines: looped runs against 3e's scanned arms
    by_name = {arm["name"]: arm for arm in arms}
    for name, run, rounds in (("Hier-Local-QSGD QSGD(16)", run_hier_local_qsgd, COMPARE_ROUNDS),
                              ("FedAvg", run_fedavg, COMPARE_ROUNDS),
                              ("WRWGD", run_wrwgd, WALK_ROUNDS)):
        arm = by_name[name]
        cfg_b = dataclasses.replace(arm["config"], scan_rounds=False)
        loop = comparison_arm(torch, build, name, lambda run=run, c=cfg_b: run(task, c), rounds)
        same_run(torch, f"3i-a {name}", arm["res"], loop["res"])
        check(loop["launches"] == arm["launches"], f"3i-a {name}: launches differ")
        print(f"phase 3i-a: {name}: scanned (3e) {arm['s_per_round']:.3f} s/round, looped "
              f"{loop['s_per_round']:.3f} s/round; params, eval trace and ledger equal")

    # 3i-c: a chunk of replays under the sync debug mode "error"
    plan, _, _ = _fed_chs_scan_plan(task, task.source, dataclasses.replace(cfg, rounds=8))
    rounds = engine._GraphRounds(plan.body, plan.carry, plan.consts, torch.device("cuda"))
    try:
        rounds.run(plan.stage(np.arange(0, 4)))  # the warm-up round, the capture, 3 replays
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            losses = rounds.run(plan.stage(np.arange(4, 8)))  # stage, copy, 4 replays
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        check(bool(torch.isfinite(losses).all()), "3i-c: non-finite losses")
    finally:
        rounds.close()
    check(engine.LIVE_GRAPHS == [], "3i-c: a graph outlived its run")
    print("phase 3i-c: a chunk of 4 rounds (staging, one host-to-device copy, 4 replays) ran "
          "under torch.cuda.set_sync_debug_mode('error') without a host sync")

    # 3i-d: a sweep of 3 seeds against their solo scanned runs
    sweep_cfg = dataclasses.replace(cfg, rounds=SWEEP_ROUNDS, eval_every=1)
    solo = [timed(torch, lambda s=s: run_fed_chs(task, dataclasses.replace(sweep_cfg, seed=s)))
            for s in SWEEP_SEEDS]
    lanes, sweep_ms = timed(torch, lambda: run_sweep(task, sweep_cfg, SWEEP_SEEDS))
    for s, (res, _), lane in zip(SWEEP_SEEDS, solo, lanes):
        same_run(torch, f"3i-d seed {s}", lane, res)
    solo_ms = sum(ms for _, ms in solo)
    print(f"phase 3i-d: run_sweep of seeds {SWEEP_SEEDS}, {SWEEP_ROUNDS} rounds: each lane "
          f"equals its solo scanned run (params bit for bit, eval trace, ledger); "
          f"{sweep_ms / 1e3 / SWEEP_ROUNDS / len(SWEEP_SEEDS):.3f} s/round per seed swept, "
          f"{solo_ms / 1e3 / SWEEP_ROUNDS / len(SWEEP_SEEDS):.3f} s/round per seed solo")


def eval_clock(torch, task) -> list:
    """Host timestamps (after a synchronize) at the start of each of the
    task's evals: with an eval every round, their differences are rounds
    with their evals.  `del task.evaluate` restores the task."""
    stamps, evaluate = [], task.evaluate

    def clocked(params):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return evaluate(params)

    task.evaluate = clocked
    return stamps


def scanned_lm_path(torch, build):
    """Phase 3i-b: qwen3-0.6b at full width and depth under 3h's lean
    configuration with QSGD(16), scanned against looped for 3h's rounds;
    warm s/round from the eval timestamps, the kernel share of a warm
    round, and the peak with the graph's pool."""
    from repro_torch.comm.channels import QSGDChannel
    from repro_torch.configs.registry import get_config
    from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
    from repro_torch.core.precision import Precision

    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    task = lm_task(cfg, remat=True, num_clients=LM_CLIENTS, batch_size=LM_BATCH, seq_len=LM_SEQ)
    config = FedCHSConfig(rounds=LEAN_ROUNDS, local_steps=LM_K, local_epochs=LM_E,
                          eval_every=1, channel=QSGDChannel(16), seed=0,
                          schedule=lambda k: LM_LR, client_microbatch=LEAN_MB,
                          precision=Precision())
    looped_cfg = dataclasses.replace(config, scan_rounds=False)
    warm = {}
    for label, c in (("scanned", config), ("looped", looped_cfg)):
        stamps = eval_clock(torch, task)
        warm[label] = arm = comparison_arm(torch, build, label, lambda c=c: run_fed_chs(task, c),
                                           LEAN_ROUNDS)
        del task.evaluate
        # rounds 2..: round 1 of a scanned run also holds the capture
        arm["warm_s"] = statistics.median(b - a for a, b in zip(stamps[1:], stamps[2:]))
        arm["reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
        if c.scan_rounds:
            arm["stats"] = executor_stats()
    scanned, looped = warm["scanned"], warm["looped"]
    same_run(torch, "3i-b", scanned["res"], looped["res"])
    check(scanned["launches"] == looped["launches"], "3i-b: launch counts differ: "
          f"{scanned['launches']} scanned, {looped['launches']} looped")
    res = scanned["res"]
    check(res.train_loss[-1] < res.train_loss[0] and res.test_acc[-1] < res.test_acc[0],
          "3i-b: loss or perplexity did not fall")
    # the kernel time of one round and its eval: a one-round run is one
    # eager round, and runs the kernels a replayed round runs
    one = dataclasses.replace(config, rounds=1)
    _, busy_ms, _, one_ms = kernel_share(torch, lambda: run_fed_chs(task, one),
                                         "one round with its eval (eager)")
    print(f"phase 3i-b: {LM_ARCH} lean Fed-CHS QSGD(16), {LEAN_ROUNDS} rounds: params bit-equal "
          f"scanned vs looped, eval trace and ledger equal, launches {scanned['launches']} both; "
          f"perplexity {res.test_acc}, train loss {res.train_loss}; the executor: "
          f"{scanned['stats']}")
    for arm in (scanned, looped):
        print(f"  {arm['name']}: {LEAN_ROUNDS} rounds with evals {arm['s_per_round']:.3f} s/round; "
              f"warm round with its eval {arm['warm_s']:.3f} s (median of rounds 2-"
              f"{LEAN_ROUNDS - 1}), kernel share {100 * busy_ms / 1e3 / arm['warm_s']:.1f}%; "
              f"peak allocated {arm['peak_gb']:.2f} GB, reserved {arm['reserved_gb']:.2f} GB "
              f"(3h looped, PR 17: 1.876 s, 28.68 GB)")


# phase 3j: the host services.  Telemetry taps and spans (obs/), run
# checkpoints (checkpoint/) and the event-driven async drivers (async_fl/),
# at the Appendix-A scale of 3a with QSGD(16) uplinks, plus one tapped
# qwen3-0.6b run.
ASYNC_ACTIVATIONS, ASYNC_FOLDS, ANCHOR_ACTIVATIONS, ASYNC_KILL_AT = 20, 10, 4, 10
ASYNC_GAMMA = 0.70  # benchmarks/fig_async.py's GAMMA
# the steps of each async arm that are profiled for its kernel share
ASYNC_PROFILED = {"Fed-CHS": 5, "FedAvg (FedBuff)": 2, "Hier (FedAsync)": 3}
TELE_KEYS = ("update_norm", "drift", "comp_err", "mass")


def async_scenarios():
    """benchmarks/fig_async.py's two scenarios: network, availability trace,
    quorum and deadline."""
    from repro_torch.netsim.links import edge_cloud_network
    from repro_torch.part import AlwaysOn, BernoulliTrace

    return {
        "straggler": dict(network=lambda: edge_cloud_network(
            seed=0, heterogeneity=0.4, straggler_frac=0.3, straggler_slowdown=16.0),
            trace=AlwaysOn, quorum_frac=0.7, deadline_s=None),
        "churn": dict(network=lambda: edge_cloud_network(
            seed=0, heterogeneity=0.3, straggler_frac=0.15, straggler_slowdown=8.0),
            trace=lambda: BernoulliTrace(p=0.8, seed=7), quorum_frac=0.8, deadline_s=5.0),
    }


def tele_close(name, a, b, rtol=1e-6) -> None:
    """Two runs' recorded tele: the same rounds, every value within `rtol`
    (comp_err of a dense channel, a float residual, within 1e-7 absolute)."""
    import numpy as np

    check(a.rounds == b.rounds, f"{name}: tele rounds {a.rounds} != {b.rounds}")
    for k, vs in b.metrics.items():
        got, want = np.asarray(a.metrics[k]), np.asarray(vs)
        check(np.allclose(got, want, rtol=rtol, atol=1e-7 if k.endswith("comp_err") else 0),
              f"{name}: tele {k} {got} differs from {want}")


def telemetry_path(torch, build, task, arms):
    """Phase 3j-a at the scale of 3a: Fed-CHS QSGD(16) scanned with
    `RunTelemetry()` and without (params, eval trace and ledger bit-equal,
    B1 and B2 counts unchanged), the tele's invariants (mass = the cluster's
    10 clients every round, comp_err > 0, all finite), the looped tapped
    run's tele within 1e-6, a chunk of tapped replays under the sync debug
    mode "error", a Chrome trace of the run and its netsim replay, span
    names in a `torch.profiler` trace, and 3e's baselines tapped against
    their untapped arms."""
    from repro_torch.comm.channels import QSGDChannel
    from repro_torch.core import engine
    from repro_torch.core.baselines import run_fedavg, run_hier_local_qsgd, run_wrwgd
    from repro_torch.core.fed_chs import FedCHSConfig, _fed_chs_scan_plan, run_fed_chs
    from repro_torch.netsim import edge_cloud_network, replay_run
    from repro_torch.obs import RunTelemetry, build_chrome_trace, validate_chrome_trace

    import numpy as np

    leaf_sizes = task.param_leaf_sizes()
    L, J = len(leaf_sizes), MAIN_K // MAIN_E
    cfg = FedCHSConfig(rounds=MAIN_ROUNDS, local_steps=MAIN_K, local_epochs=MAIN_E,
                       eval_every=2, channel=QSGDChannel(16), seed=0)
    obs = RunTelemetry()
    # untapped, tapped, tapped, untapped: each version's s/round the mean of
    # its two runs
    plain = comparison_arm(torch, build, "untapped", lambda: run_fed_chs(task, cfg), MAIN_ROUNDS)
    tapped = comparison_arm(torch, build, "tapped",
                            lambda: run_fed_chs(task, dataclasses.replace(cfg, obs=obs)),
                            MAIN_ROUNDS)
    tapped2 = comparison_arm(
        torch, build, "tapped",
        lambda: run_fed_chs(task, dataclasses.replace(cfg, obs=RunTelemetry())), MAIN_ROUNDS)
    plain2 = comparison_arm(torch, build, "untapped", lambda: run_fed_chs(task, cfg),
                            MAIN_ROUNDS)
    for a, b in ((tapped, plain), (tapped2, plain), (plain2, plain)):
        same_run(torch, f"3j-a Fed-CHS {a['name']}", a["res"], b["res"])
    want = MAIN_ROUNDS * J * L
    check(tapped["launches"] == plain["launches"] and all(
        plain["launches"][k] == want for k in PACKED_KERNELS),
        f"3j-a: launches tapped {tapped['launches']}, untapped {plain['launches']}, "
        f"expected {want} of each packed kernel")
    check(obs.rounds == list(range(MAIN_ROUNDS)), f"3j-a: tele rounds {obs.rounds}")
    check(all(m == 10.0 for m in obs.metrics["mass"]), f"3j-a: mass {obs.metrics['mass']}")
    check(all(e > 0 for e in obs.metrics["comp_err"]), "3j-a: comp_err not > 0")
    check(all(math.isfinite(v) for k in TELE_KEYS for v in obs.metrics[k]),
          "3j-a: non-finite tele")
    looped_obs = RunTelemetry()
    run_fed_chs(task, dataclasses.replace(cfg, obs=looped_obs, scan_rounds=False))
    tele_close("3j-a scanned vs looped", obs, looped_obs)
    print(f"phase 3j-a: LeNet-MNIST Fed-CHS QSGD(16), {MAIN_ROUNDS} rounds scanned, run "
          f"untapped, tapped, tapped, untapped: tapped {tapped['s_per_round']:.3f} and "
          f"{tapped2['s_per_round']:.3f} s/round, peak {tapped['peak_gb']:.2f} GB; untapped "
          f"{plain['s_per_round']:.3f} and {plain2['s_per_round']:.3f} s/round, peak "
          f"{plain['peak_gb']:.2f} GB (evals included); tapped/untapped "
          f"{(tapped['s_per_round'] + tapped2['s_per_round']) / (plain['s_per_round'] + plain2['s_per_round']):.3f}; "
          f"params, eval trace and ledger bit-equal, B1 = B2 = {want} both; the "
          f"looped tapped run's tele within 1e-6; spans (s): "
          f"{ {k: round(v, 4) for k, v in obs.summary()['spans'].items()} }")
    for row in obs.metrics_rows():
        print(f"  tele {row}")

    # a chunk of tapped replays under the sync debug mode "error", its tele
    # recorded lazily (sync_chunks=False) inside the mode
    chunk_obs = RunTelemetry()
    plan, _, _ = _fed_chs_scan_plan(task, task.source,
                                    dataclasses.replace(cfg, rounds=8, obs=chunk_obs))
    rounds = engine._GraphRounds(plan.body, plan.carry, plan.consts, torch.device("cuda"),
                                 tapped=True)
    try:
        rounds.run(plan.stage(np.arange(0, 4)))  # the warm-up round, the capture, 3 replays
        chunk_obs.record_stacked(range(0, 4), rounds.tele)
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            rounds.run(plan.stage(np.arange(4, 8)))  # stage, copy, 4 replays, 4 tele copies
            chunk_obs.record_stacked(range(4, 8), rounds.tele)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    finally:
        rounds.close()
    norms = chunk_obs.metrics["update_norm"]
    check(chunk_obs.rounds == list(range(8)) and len(set(norms)) == 8
          and all(math.isfinite(v) for v in norms),
          f"3j-a: the replayed rounds' tele {norms}: not one row per round")
    print("phase 3j-a: a chunk of 4 tapped replays (sync_chunks=False) ran under "
          "torch.cuda.set_sync_debug_mode('error'); each replay's tele in its own row "
          f"(update_norm {[round(v, 5) for v in norms]})")

    # the run's Chrome trace with a netsim replay
    res = tapped["res"]
    jobs, tl = replay_run(res, edge_cloud_network(seed=0), local_steps=MAIN_K,
                          batch_size=task.batch_size, num_params=sum(leaf_sizes))
    trace = build_chrome_trace(obs, res.ledger, jobs, tl)
    problems = validate_chrome_trace(trace, expected_comm_events=len(res.ledger.events))
    check(problems == [], f"3j-a: Chrome trace problems {problems[:5]}")
    n_comm = sum(e.get("cat") == "comm" for e in trace["traceEvents"])
    print(f"phase 3j-a: Chrome trace: {len(trace['traceEvents'])} events valid, {n_comm} comm "
          f"instants = {len(res.ledger.events)} ledger events, {len(jobs)} netsim jobs, "
          f"makespan {tl.makespan:.2f} s under edge_cloud_network(seed=0)")

    # the span names inside a torch.profiler trace (profiler=True)
    from torch.profiler import ProfilerActivity, profile

    prof_obs = RunTelemetry(profiler=True)
    short = dataclasses.replace(cfg, rounds=2, eval_every=1, obs=prof_obs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_fed_chs(task, short)
        run_fed_chs(task, dataclasses.replace(short, rounds=1, scan_rounds=False))
        torch.cuda.synchronize()
    seen = {e.name for e in prof.events()}
    spans = {"precompute", "stage", "scan_chunk", "eval", "materialize", "round"}
    check(spans <= seen, f"3j-a: span names missing from the profile: {spans - seen}")
    print(f"phase 3j-a: torch.profiler holds the spans {sorted(spans)} (profiler=True)")

    # the baselines, tapped, against 3e's untapped scanned arms
    by_name = {arm["name"]: arm for arm in arms}
    for name, run in (("Hier-Local-QSGD QSGD(16)", run_hier_local_qsgd), ("FedAvg", run_fedavg),
                      ("WRWGD", run_wrwgd)):
        arm = by_name[name]
        b_obs = RunTelemetry()
        c = dataclasses.replace(arm["config"], obs=b_obs)
        b = comparison_arm(torch, build, name, lambda run=run, c=c: run(task, c), arm["rounds"])
        same_run(torch, f"3j-a {name} tapped", b["res"], arm["res"])
        check(b["launches"] == arm["launches"], f"3j-a {name}: launches differ")
        check(all(np.all(np.isfinite(v)) for vs in b_obs.metrics.values() for v in vs),
              f"3j-a {name}: non-finite tele")
        last = b_obs.metrics_rows()[-1]
        print(f"phase 3j-a: {name}: tapped {b['s_per_round']:.3f} s/round against 3e's "
              f"{arm['s_per_round']:.3f}, peak {b['peak_gb']:.2f} GB against "
              f"{arm['peak_gb']:.2f}; params, eval trace, ledger and launches equal; last "
              f"round's tele { {k: np.round(v, 5).tolist() for k, v in last.items()} }")


def telemetry_lm_path(torch, build):
    """Phase 3j-a's LM arm: qwen3-0.6b at full width and depth as in 3b (f32,
    flash, QSGD(16)), 2 rounds tapped against 2 untapped: params bit-equal,
    launches equal, and both peaks."""
    from repro_torch.comm.channels import QSGDChannel
    from repro_torch.configs.registry import get_config
    from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
    from repro_torch.obs import RunTelemetry

    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    task = lm_task(cfg, num_clients=LM_CLIENTS, batch_size=LM_BATCH, seq_len=LM_SEQ)
    config = FedCHSConfig(rounds=2, local_steps=LM_K, local_epochs=LM_E, eval_every=1,
                          channel=QSGDChannel(16), seed=0, schedule=lambda k: LM_LR)
    obs = RunTelemetry()
    plain = comparison_arm(torch, build, "untapped", lambda: run_fed_chs(task, config), 2)
    tapped = comparison_arm(torch, build, "tapped",
                            lambda: run_fed_chs(task, dataclasses.replace(config, obs=obs)), 2)
    same_run(torch, "3j-a LM tapped", tapped["res"], plain["res"])
    check(tapped["launches"] == plain["launches"], "3j-a LM: launches differ")
    check(all(m == 2.0 for m in obs.metrics["mass"]) and all(
        math.isfinite(v) for k in TELE_KEYS for v in obs.metrics[k]), "3j-a LM: tele")
    print(f"phase 3j-a: {LM_ARCH} Fed-CHS QSGD(16), 2 rounds (f32, flash): tapped "
          f"{tapped['s_per_round']:.3f} s/round, peak {tapped['peak_gb']:.2f} GB; untapped "
          f"{plain['s_per_round']:.3f} s/round, peak {plain['peak_gb']:.2f} GB; params bit-equal, "
          f"launches {plain['launches']} both; tele {obs.metrics_rows()}")


def checkpoint_path(torch, build, task):
    """Phase 3j-b: the looped Fed-CHS driver checkpointed after 2 of 4
    rounds and resumed, against the uninterrupted scanned run (params bit
    for bit, ledger and accuracy equal), at 3a's scale; then 3a's MLP task
    under `Precision()`, `MomentumSGD()` and client_microbatch 2, whose run
    state holds bf16 momentum beside f32 params.  The save and load seconds
    and the file size of the LeNet run state."""
    import tempfile

    import numpy as np

    from repro_torch.checkpoint.io import load_run_state, read_run_meta, save_run_state
    from repro_torch.comm.channels import QSGDChannel
    from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
    from repro_torch.core.precision import Precision
    from repro_torch.core.prng import PRNGKey
    from repro_torch.core.simulation import FLTask
    from repro_torch.data.partition import assign_clusters, dirichlet_partition
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.models.classifier import make_classifier
    from repro_torch.optim.local import MomentumSGD

    ds = make_dataset("mnist", train_size=4000, test_size=1000, seed=0)
    mlp_task = FLTask(make_classifier("mlp", "mnist", ds.spec.image_shape, 10), ds,
                      dirichlet_partition(ds.train_y, 20, 0.6, seed=0),
                      assign_clusters(20, 4, seed=0), batch_size=32, seed=0)
    arms = (("LeNet QSGD(16)", task, FedCHSConfig(
                rounds=4, local_steps=MAIN_K, local_epochs=MAIN_E, eval_every=1,
                channel=QSGDChannel(16), seed=0)),
            ("MLP QSGD(16), Precision(), MomentumSGD(), client_microbatch 2", mlp_task,
             FedCHSConfig(rounds=4, local_steps=10, local_epochs=5, eval_every=1,
                          channel=QSGDChannel(16), precision=Precision(),
                          local_opt=MomentumSGD(), client_microbatch=2, seed=0)))
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, t, cfg) in enumerate(arms):
            ck = f"{tmp}/run{i}"
            base = run_fed_chs(t, cfg)  # scanned
            run_fed_chs(t, dataclasses.replace(cfg, rounds=2, checkpoint=ck))
            resumed = run_fed_chs(t, dataclasses.replace(cfg, checkpoint=ck, resume=True))
            gap = params_gap(torch, resumed, base)
            check(gap == 0.0, f"3j-b {name}: resumed params differ by up to {gap:.3g}")
            check(resumed.test_acc == base.test_acc and resumed.rounds == base.rounds,
                  f"3j-b {name}: eval trace {resumed.test_acc} != {base.test_acc}")
            check(resumed.ledger.events == base.ledger.events
                  and resumed.ledger.history == base.ledger.history,
                  f"3j-b {name}: the resumed ledger differs")
            with np.load(ck + ".arrays.npz") as data:
                stored = {part: sorted({str(data[k].dtype) for k in data.files
                                        if k.startswith(part + "/")})
                          for part in ("params", "opt")}
            size_mb = os.path.getsize(ck + ".arrays.npz") / 1e6
            print(f"phase 3j-b: {name}: looped with a checkpoint after 2 of 4 rounds, then "
                  f"resumed: params bit-equal to the uninterrupted scanned run, eval trace "
                  f"{resumed.test_acc} and ledger equal; run state {size_mb:.2f} MB, stored "
                  f"dtypes {stored}")
            if cfg.precision is not None:
                check(stored == {"params": ["float32"], "opt": ["uint16"]},
                      f"3j-b {name}: expected bf16 momentum beside f32 params, got {stored}")
                continue
            # this run state's load (to the card) and save, timed alone
            meta = read_run_meta(ck)
            like = {"params": t.init_params(), "key": PRNGKey(0),
                    "losses": torch.zeros(meta["losses_shape"], device="cuda"),
                    "opt": {str(m): () for m in meta["opt_clusters"]}}
            t0 = time.perf_counter()
            arrays, meta = load_run_state(ck, like)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            save_run_state(f"{tmp}/again", arrays, meta)
            save_s = time.perf_counter() - t0
            print(f"  the LeNet run state ({size_mb:.2f} MB): save {save_s:.3f} s from the card, "
                  f"load {load_s:.3f} s to the card")


class _Killed(Exception):
    """Raised from `on_checkpoint`: an in-process kill right after a save."""


def kernel_time(torch, run):
    """(result, kernel ms) of `run()` under a profiler that traces the card
    only: no host-op events, so a run of many small operations costs little
    more than unprofiled."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = run()
        torch.cuda.synchronize()
    return result, sum(e.device_time_total for e in prof.key_averages()
                       if e.device_time_total > 0 and str(e.device_type).endswith("CUDA")) / 1e3


def async_checks(torch, name, res, L, up, down) -> int:
    """One async arm's invariants; returns its cohort computations.

    B1 and B2 launch once per leaf per cohort computation: a computation
    trains its dispatched clients together and compresses their uplinks in
    one call, which encodes and decodes each leaf for every sender at once.
    The computations are read off the run's downlink events: Fed-CHS
    broadcasts once per activation with a cohort (distinct rounds of
    es_to_client), FedAvg once per version with a dispatch (distinct rounds
    of ps_to_client), and each ES of Hier once per (PS version, ES) pair
    (distinct (round, sender) of es_to_client)."""
    from repro_torch.utils import tree_leaves

    led = res.ledger
    downs = [e for e in led.events if e.hop in ("es_to_client", "ps_to_client")]
    key = (lambda e: (e.round, e.sender)) if name.startswith("Hier") else (lambda e: e.round)
    cohorts = len({key(e) for e in downs})
    bits = {"client_to_es": up, "client_to_ps": up, "es_to_ps": up,
            "es_to_client": down, "ps_to_client": down, "es_to_es": down, "ps_to_es": down}
    check(all(e.n_bits == bits[e.hop] for e in led.events),
          f"3j-c {name}: an event off its closed-form bits")
    check(all(led.bits[h] == led.messages[h] * bits[h] for h in led.messages),
          f"3j-c {name}: ledger totals off the closed form")
    hist = led.staleness_histogram()
    check(sum(hist.values()) > 0, f"3j-c {name}: empty staleness histogram")
    st = res.sim_times
    check(len(st) == len(res.test_acc) and all(b >= a for a, b in zip(st, st[1:]))
          and (not name.startswith("Fed-CHS") or all(b > a for a, b in zip(st, st[1:]))),
          f"3j-c {name}: sim_times {st}")
    check(all(math.isfinite(x) for x in res.test_acc + res.train_loss + st),
          f"3j-c {name}: non-finite trace")
    check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(res.final_params)),
          f"3j-c {name}: non-finite params")
    return cohorts


def async_path(torch, build, task):
    """Phase 3j-c at the scale of 3a, QSGD(16) uplinks: `run_async_fed_chs`
    under benchmarks/fig_async.py's straggler and churn scenarios, and
    `run_async_fedavg` / `run_async_hier` with quorum_k = N // 5; per arm
    the launch counts, closed-form bits, staleness, simulated clock,
    s/activation, peak and kernel share; the sync anchor; a kill at an
    activation and the resume; time to Γ in simulated seconds."""
    import tempfile

    from repro_torch.async_fl import (
        AsyncFedCHSConfig,
        AsyncPSConfig,
        run_async_fed_chs,
        run_async_fedavg,
        run_async_hier,
    )
    from repro_torch.comm.channels import DenseChannel, QSGDChannel, channel_wire_bits
    from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
    from repro_torch.netsim import simulate_run, time_to_accuracy

    K = MAIN_K
    leaf_sizes = task.param_leaf_sizes()
    L, d = len(leaf_sizes), sum(leaf_sizes)
    up, down = channel_wire_bits(QSGDChannel(16), d, leaf_sizes), DenseChannel().message_bits(d)
    packed = ("qsgd_quantize_pack", "qsgd_unpack_dequantize")
    scenarios = async_scenarios()

    def configs(spec):
        chs = AsyncFedCHSConfig(
            rounds=ASYNC_ACTIVATIONS, local_steps=K, eval_every=1, network=spec["network"](),
            trace=spec["trace"](), quorum_frac=spec["quorum_frac"],
            deadline_s=spec["deadline_s"], qsgd_levels=16, seed=0)
        ps = AsyncPSConfig(rounds=ASYNC_FOLDS, local_steps=K, quorum_k=task.num_clients // 5,
                           eval_every=1, network=spec["network"](), trace=spec["trace"](),
                           qsgd_levels=16, seed=0)
        return (("Fed-CHS", run_async_fed_chs, chs, ASYNC_ACTIVATIONS),
                ("FedAvg (FedBuff)", run_async_fedavg, ps, ASYNC_FOLDS),
                ("Hier (FedAsync)", run_async_hier, ps, ASYNC_FOLDS))

    t_part = time.perf_counter()

    def part(label):
        nonlocal t_part
        print(f"  [3j-c: {label} in {time.perf_counter() - t_part:.1f} s]")
        t_part = time.perf_counter()

    results = {}
    for scen, spec in scenarios.items():
        for name, run, cfg, steps in configs(spec):
            arm = comparison_arm(torch, build, name, lambda run=run, cfg=cfg: run(task, cfg),
                                 steps)
            res = arm["res"]
            cohorts = async_checks(torch, name, res, L, up, down)
            for k, v in arm["launches"].items():
                want = L * cohorts if k in packed else 0
                check(v == want, f"3j-c {name}, {scen}: {k} launched {v} times, expected "
                                 f"{want} = {L} leaves x {cohorts} cohort computations")
            share = ""
            if scen == "churn" or name == "Fed-CHS":
                # the kernel share of the run's first ASYNC_PROFILED steps: the
                # kernel time of a profiled run of them over the wall of an
                # unprofiled one (CUPTI makes a whole profiled run slow)
                head = dataclasses.replace(cfg, rounds=ASYNC_PROFILED[name])
                _, head_ms = timed(torch, lambda run=run, head=head: run(task, head))
                again, busy_ms = kernel_time(torch, lambda run=run, head=head: run(task, head))
                check(again.sim_times == res.sim_times[:head.rounds],
                      f"3j-c {name}: the first {head.rounds} steps differ from the run's")
                share = (f", kernel share of the first {head.rounds}: {busy_ms:.0f} ms of "
                         f"{head_ms:.0f} = {100 * busy_ms / head_ms:.1f}%")
            results[scen, name] = arm
            print(f"phase 3j-c: async {name}, {scen}: {steps} {'activations' if steps == ASYNC_ACTIVATIONS else 'folds'}, "
                  f"{arm['s_per_round']:.3f} s each (evals included), peak "
                  f"{arm['peak_gb']:.2f} GB{share}; B1 = B2 = {L * cohorts} = {L} leaves x "
                  f"{cohorts} cohort computations; bits at the closed form "
                  f"{ {h: n for h, n in res.ledger.messages.items() if n} } messages; "
                  f"staleness {dict(sorted(res.ledger.staleness_histogram().items()))}; "
                  f"sim {res.sim_times[0]:.2f} .. {res.sim_times[-1]:.2f} s; accuracy "
                  f"{res.test_acc[-1]:.4f}")
            part(f"{name}, {scen}")

    # the sync anchor: AlwaysOn, quorum 1.0, no deadline = run_fed_chs(E = K)
    anchor = AsyncFedCHSConfig(rounds=ANCHOR_ACTIVATIONS, local_steps=K, eval_every=1,
                               quorum_frac=1.0, deadline_s=None, qsgd_levels=16, seed=0)
    a = comparison_arm(torch, build, "anchor", lambda: run_async_fed_chs(task, anchor),
                       ANCHOR_ACTIVATIONS)
    s = comparison_arm(torch, build, "sync", lambda: run_fed_chs(task, FedCHSConfig(
        rounds=ANCHOR_ACTIVATIONS, local_steps=K, local_epochs=K, eval_every=1,
        qsgd_levels=16, seed=0)), ANCHOR_ACTIVATIONS)
    gap = params_gap(torch, a["res"], s["res"])
    check(gap == 0.0 and a["res"].test_acc == s["res"].test_acc,
          f"3j-c: the sync anchor's params differ by up to {gap:.3g}")
    check(a["launches"] == s["launches"], f"3j-c anchor: launches {a['launches']} async, "
                                          f"{s['launches']} sync")
    print(f"phase 3j-c: sync anchor, {ANCHOR_ACTIVATIONS} activations (AlwaysOn, quorum 1.0, "
          f"no deadline) against run_fed_chs(local_epochs=K): params bit-equal, accuracy "
          f"{a['res'].test_acc} equal, launches equal; {a['s_per_round']:.3f} s/activation "
          f"async, {s['s_per_round']:.3f} s/round sync")
    part("the sync anchor")

    # an in-process kill right after the save of activation ASYNC_KILL_AT
    name, run, cfg, _ = configs(scenarios["churn"])[0]
    full = results["churn", name]["res"]

    def kill(act):
        if act == ASYNC_KILL_AT:
            raise _Killed

    with tempfile.TemporaryDirectory() as tmp:
        ck = f"{tmp}/async"
        t0 = time.perf_counter()
        try:
            run_async_fed_chs(task, dataclasses.replace(
                cfg, checkpoint=ck, checkpoint_every=ASYNC_KILL_AT, on_checkpoint=kill))
            fail("3j-c: the kill switch did not fire")
        except _Killed:
            pass
        killed_s = time.perf_counter() - t0
        with open(ck + ".meta.json") as f:
            pending = len(json.load(f)["pending"])
        size_mb = os.path.getsize(ck + ".arrays.npz") / 1e6
        t0 = time.perf_counter()
        resumed = run_async_fed_chs(task, dataclasses.replace(
            cfg, checkpoint=ck, checkpoint_every=ASYNC_KILL_AT, resume=True))
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
    gap = params_gap(torch, resumed, full)
    check(gap == 0.0 and resumed.sim_times == full.sim_times
          and resumed.test_acc == full.test_acc and resumed.ledger.bits == full.ledger.bits
          and resumed.ledger.staleness_histogram() == full.ledger.staleness_histogram(),
          f"3j-c: the resumed churn run differs (params up to {gap:.3g})")
    print(f"phase 3j-c: async Fed-CHS, churn, killed after the save of activation "
          f"{ASYNC_KILL_AT} ({killed_s:.1f} s; the run state {size_mb:.1f} MB, {pending} "
          f"buffered updates) and resumed ({resumed_s:.1f} s): params bit-equal to the "
          f"uninterrupted run; sim_times, bits and staleness histogram equal")
    part("the kill and the resume")

    # time to Γ in simulated seconds; sync Fed-CHS (E = K) replayed through
    # each scenario's network
    sync = run_fed_chs(task, FedCHSConfig(rounds=ASYNC_ACTIVATIONS, local_steps=K,
                                          local_epochs=K, eval_every=1, qsgd_levels=16,
                                          seed=0))
    names = ["Fed-CHS", "FedAvg (FedBuff)", "Hier (FedAsync)"]
    fmt = lambda t: "-" if t is None else f"{t:.2f}"  # noqa: E731
    print(f"phase 3j-c: simulated seconds to accuracy {ASYNC_GAMMA} ('-': not reached; sync "
          f"Fed-CHS, E = K, {ASYNC_ACTIVATIONS} rounds, accuracy {sync.test_acc[-1]:.4f}):")
    print(f"  {'scenario':10s} {'sync Fed-CHS':>13s} " + " ".join(f"{'async ' + n:>23s}"
                                                               for n in names))
    for scen, spec in scenarios.items():
        tl = simulate_run(task, sync, spec["network"](), local_steps=K)
        row = [time_to_accuracy(sync, tl, ASYNC_GAMMA)] + [
            results[scen, n]["res"].sim_time_to_accuracy(ASYNC_GAMMA) for n in names]
        print(f"  {scen:10s} {fmt(row[0]):>13s} " + " ".join(f"{fmt(t):>23s}" for t in row[1:]))
    part("the sync run and its replays")


def time_launches(torch, fn, reps, flush):
    """Median of per-launch CUDA-event times (ms), L2 flushed before each.
    A spin of about a millisecond on the card comes first, so the host has
    enqueued the flush, the events and the launch before the card reaches
    them: the interval is the card's time, not the wrapper's host time."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    bytes_ms, ops_ms = nbytes / MEM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def timed_row(torch, flush, name, label, nbytes, ops, kernel, plain, library=None,
              ops_per_s=F32_OPS_PER_S, reps=50):
    ms = time_launches(torch, kernel, reps, flush)
    plain_ms = time_launches(torch, plain, 5, flush)
    library_ms = time_launches(torch, library, reps, flush) if library else None
    bound_ms, bound_by = bound(nbytes, ops, ops_per_s)
    lib = f"; library {library_ms:.4f} ms" if library else ""
    print(f"phase 4: {name} [{label}]: {ms:.4f} ms median (plain {plain_ms:.3f} ms{lib}); "
          f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GOP); "
          f"{ms / bound_ms:.2f}x the bound")
    return {"name": name, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def qsgd_timings(torch, qsgd, ref, flush, lm_sizes):
    """Phase 4, QSGD: each kernel at its path's largest launch, the LM's
    embedding leaf (151936 blocks of 1024; 2 senders on the packed wire),
    and the packed pair also at the LeNet fc1/w leaf as the comparison path
    launches it: 10 senders (Fed-CHS, the ES hop), 100 (Hier-Local-QSGD's
    client grid), and 10 at 4-bit codes (s = 7); then unpack -> dequantize
    over whole messages."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    block = 1024
    rows = {}
    for label, senders, nb, s in (("LM embed leaf x 2 senders", 2, 151936, 16),
                                  ("LeNet fc1/w leaf x 10 senders", 10, 6272, 16),
                                  ("LeNet fc1/w leaf x 100 senders", 100, 6272, 16),
                                  ("LeNet fc1/w leaf x 10 senders", 10, 6272, 7)):
        bits = ref.qsgd_code_bits(s)
        v = torch.randn((senders, nb, block), generator=gen, device="cuda")
        keys = torch.randint(-2**31, 2**31, (senders, 2), generator=gen, device="cuda",
                             dtype=torch.int64).to(torch.int32)
        payload, norms = qsgd.qsgd_quantize_pack(v, keys, s)
        prow, nrow = payload.reshape(-1, payload.shape[-1]), norms.reshape(-1)
        n = senders * nb * block
        q_bytes = 4 * n + bits * n // 8 + 4 * senders * nb + 8 * senders
        u_bytes = bits * n // 8 + 4 * senders * nb + 4 * n
        # f32 arithmetic; the hash's integer operations are not counted
        rows.setdefault("qsgd_quantize_pack", timed_row(
            torch, flush, "qsgd_quantize_pack", f"{label}, s={s}", q_bytes, 8 * n,
            lambda: qsgd.qsgd_quantize_pack(v, keys, s),
            lambda: qsgd.qsgd_quantize_pack_plain(v, keys, s)))
        rows.setdefault("qsgd_unpack_dequantize", timed_row(
            torch, flush, "qsgd_unpack_dequantize", f"{label}, s={s}", u_bytes,
            n + senders * nb,
            lambda: qsgd.qsgd_unpack_dequantize(prow, nrow, s, block),
            lambda: qsgd.qsgd_unpack_dequantize_plain(prow, nrow, s, block)))
        del v, payload, norms, prow, nrow
        torch.cuda.empty_cache()
    message_decode_timings(torch, qsgd, ref, flush, lm_sizes)
    s, nb = 16, 151936
    v = torch.randn((nb, block), generator=gen, device="cuda")
    key = torch.randint(-2**31, 2**31, (2,), generator=gen, device="cuda",
                        dtype=torch.int64).to(torch.int32)
    q, norms = qsgd.qsgd_quantize_blocks(v, key, s)
    n = nb * block
    label = f"LM embed leaf, one message, s={s}"
    rows["qsgd_quantize"] = timed_row(
        torch, flush, "qsgd_quantize", label, 4 * n + n + 4 * nb + 8, 8 * n,
        lambda: qsgd.qsgd_quantize_blocks(v, key, s),
        lambda: qsgd.qsgd_quantize_blocks_plain(v, key, s))
    rows["qsgd_dequantize"] = timed_row(
        torch, flush, "qsgd_dequantize", label, n + 4 * nb + 4 * n, n + nb,
        lambda: qsgd.qsgd_dequantize_blocks(q, norms, s),
        lambda: qsgd.qsgd_dequantize_blocks_plain(q, norms, s))
    return rows


def message_decode_timings(torch, qsgd, ref, flush, lm_sizes):
    """Phase 4, unpack -> dequantize per uplink: one whole message decoded as
    the paths decode it, one launch per leaf with all its senders, timed as a
    sum of launches: the LM message (14 leaves x 2 senders, 2 messages a
    round) and the LeNet message (10 leaves x 10 senders, 4 a round).  It
    measures only; nothing of it enters the kernels line."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    s, block = 16, 1024
    bits = ref.qsgd_code_bits(s)
    messages = ((f"{LM_ARCH} message", 2, [math.ceil(n / block) for n in lm_sizes],
                 LM_K // LM_E),
                ("LeNet message", 10, lenet_leaf_blocks(), MAIN_K // MAIN_E))
    for label, senders, leaf_blocks, per_round in messages:
        wires = []
        for nb in leaf_blocks:
            v = torch.randn((senders, nb, block), generator=gen, device="cuda")
            keys = torch.randint(-2**31, 2**31, (senders, 2), generator=gen, device="cuda",
                                 dtype=torch.int64).to(torch.int32)
            payload, norms = qsgd.qsgd_quantize_pack(v, keys, s)
            wires.append((payload.reshape(-1, payload.shape[-1]), norms.reshape(-1)))
            del v

        def decode():
            for payload, norms in wires:
                qsgd.qsgd_unpack_dequantize(payload, norms, s, block)

        ms = time_launches(torch, decode, 20, flush)
        rows = senders * sum(leaf_blocks)
        n = rows * block
        bound_ms, bound_by = bound(bits * n // 8 + 4 * rows + 4 * n, n + rows)
        print(f"phase 4: qsgd_unpack_dequantize [{label}: {len(leaf_blocks)} leaves x "
              f"{senders} senders, {len(leaf_blocks)} launches, {rows} rows, s={s}]: "
              f"{ms:.4f} ms median per message; bound {bound_ms:.4f} ms by {bound_by}, "
              f"{ms / bound_ms:.2f}x; {per_round} messages a round: {per_round * ms:.4f} ms "
              f"a round")
        del wires


def flash_work(B, T, S, H, Hkv, hd, itemsize):
    """(bytes, operations) of causal flash attention: q, k, v read once and
    the output written once; 4 hd operations per unmasked (q, k) pair (two
    products of 2 hd each), the softmax's exp and sums not counted."""
    pairs = sum(min(q + 1, S) for q in range(T))
    nbytes = itemsize * (2 * B * T * H * hd + 2 * B * S * Hkv * hd)
    return nbytes, 4 * B * H * hd * pairs


def flash_timings(torch, fa, flush):
    """Phase 4, flash attention at the LM path's shape, f32 (the path's
    dtype) and bf16, beside torch's scaled_dot_product_attention."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(4)
    B, T, S, H, Hkv, hd = FLASH_PATH
    rows = {}
    # f32 runs as split TF32 on the tensor cores, three TF32 products per f32
    # product: its rate is a third of TF32's, and that bounds the row
    for dtype, ops_per_s in ((torch.float32, TF32_OPS_PER_S / 3),
                             (torch.bfloat16, BF16_OPS_PER_S)):
        q, k, v = flash_inputs(torch, gen, B, T, S, H, Hkv, hd, dtype)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # SDPA's (B, H, T, hd) views
        nbytes, ops = flash_work(B, T, S, H, Hkv, hd, q.element_size())
        if dtype == torch.float32:
            nbytes_f32, ops_f32 = nbytes, ops
        rows[dtype] = timed_row(
            torch, flush, "flash_attention", f"B={B} T=S={T} H={H} Hkv={Hkv} hd={hd} {dtype}",
            nbytes, ops, lambda: fa.flash_attention(q, k, v, causal=True),
            lambda: fa.flash_attention_plain(q, k, v, causal=True),
            library=lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                           enable_gqa=True),
            ops_per_s=ops_per_s)
    row, bf16 = rows[torch.float32], rows[torch.bfloat16]
    fma_ms, fma_by = bound(nbytes_f32, ops_f32, F32_OPS_PER_S)
    print(f"phase 4: flash_attention f32: {row['ms'] / row['bound_ms']:.2f}x the 3xTF32 bound "
          f"(3 x operations at {TF32_OPS_PER_S / 1e12:g} TFLOP/s of dense TF32, "
          f"{row['bound_ms']:.4f} ms by {row['bound_by']}: the bound of the row); "
          f"{row['ms'] / fma_ms:.2f}x the f32 FMA bound (operations at "
          f"{F32_OPS_PER_S / 1e12:g} TFLOP/s outside the tensor cores, {fma_ms:.4f} ms by "
          f"{fma_by}); {row['ms'] / row['library_ms']:.3f}x SDPA's f32 time; bf16 "
          f"{bf16['ms'] / bf16['library_ms']:.3f}x SDPA's bf16 time")
    return row


def main() -> None:
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found beside chip_smoke.py")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import qsgd
    from repro_torch.utils import resolve_device

    resolve_device("cuda")  # full f32 products and convolutions
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    built = build.build()
    print(f"phase 1: built {', '.join(p.name for p, _ in built.values())} in "
          f"{time.perf_counter() - t0:.2f} s")
    kernels = [k for _, log in built.values() for k in ptxas_kernels(log)]
    spilling = [k for k in kernels if k[2] or k[3]]
    print(f"  ptxas: {len(kernels)} kernels, {len(spilling)} with spills")
    shown = ptxas_shown(ref)
    for name, regs, stores, loads in kernels:
        if stores or loads or any(key in name for key in shown.values()):
            print(f"  ptxas: {name}: {regs} registers, {stores} bytes spill stores, "
                  f"{loads} bytes spill loads")
    for name, key in shown.items():
        hit = [k for k in kernels if key in k[0]]
        check(len(hit) == 1 and hit[0][2] == hit[0][3] == 0, f"{name} spills (or is missing)")
    pack, unpack = (f"{op}, block 1024, s = {PACK_LEVELS}"
                    for op in ("quantize -> pack", "unpack -> dequantize"))
    sass_per_entry(built["qsgd"][0], pack, shown[pack])
    check(sass_per_entry(built["qsgd"][0], unpack, shown[unpack])["BAR"] == 0,
          "the unpacking kernel at block 1024 has a barrier")

    lm_sizes = lm_leaf_sizes(torch)
    err = packed_vs_plain(torch, qsgd, ref, lm_sizes)
    baseline_shapes_vs_plain(torch, qsgd, ref, err)
    err.update(dense_codes_vs_plain(torch, qsgd, lm_sizes))
    err["flash_attention"] = flash_vs_plain(torch, fa)

    t_paths = time.perf_counter()

    def elapsed(done: str) -> None:
        print(f"[{time.perf_counter() - t_paths:.0f} s into the paths: {done} done]")

    lenet_task, chs_arm = lenet_path(torch, build)
    quickstart_and_cross_check(torch)
    elapsed("3a")
    launches, round_s, lm_params, lm_peak_gb = lm_path(torch, build)
    elapsed("3b")
    launches.update({k: v for k, v in dense_code_path(torch, build, lm_params).items()
                     if k in ("qsgd_quantize", "qsgd_dequantize")})
    del lm_params
    lm_cross_check(torch)
    torch.cuda.empty_cache()
    elapsed("3c, 3d")
    arms = comparison_path(torch, build, lenet_task, chs_arm)
    elapsed("3e")
    participation_path(torch, build, lenet_task, arms)
    baselines_cross_check(torch)
    elapsed("3f, 3g")
    microbatched_appendix_arms(torch, build, lenet_task, arms)
    scanned_appendix_path(torch, build, lenet_task, arms)
    elapsed("3h's 100-client arms, 3i-a, 3i-c, 3i-d")
    telemetry_path(torch, build, lenet_task, arms)
    checkpoint_path(torch, build, lenet_task)
    async_path(torch, build, lenet_task)
    elapsed("3j-a's LeNet arms, 3j-b, 3j-c")
    del lenet_task, chs_arm, arms
    torch.cuda.empty_cache()
    lean_lm_path(torch, build, lm_peak_gb, round_s)
    lean_cross_check(torch)
    elapsed("3h")
    torch.cuda.empty_cache()
    scanned_lm_path(torch, build)
    elapsed("3i-b")
    torch.cuda.empty_cache()
    telemetry_lm_path(torch, build)
    elapsed("3j-a's LM arm")
    torch.cuda.empty_cache()

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    rows = qsgd_timings(torch, qsgd, ref, flush, lm_sizes)
    rows["flash_attention"] = flash_timings(torch, fa, flush)
    elapsed("4")

    kernels = []
    for name, (source, replaces) in REPLACES.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    print(f"main path: {round_s:.3f} s per warm {LM_ARCH} Fed-CHS round on the card "
          f"(an eval included)")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
