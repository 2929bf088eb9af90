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
     shapes (2 clients of batch 2, and one client under phase 3h),
     dbrx-132b's prefill (B 4, T = S 512, H 48, Hkv 8, hd 128, bf16) and
     phase 3m's (recurrentgemma-9b's MQA local attention, H 16, Hkv 1, hd
     256, past its window of 2048 at T 2112; phi-3-vision-4.2b's 4 x 704,
     H = Hkv = 32, hd 96; whisper-tiny's 4 x 128, H = Hkv = 6, hd 64; bf16),
     atol 3e-5 in f32 and 2e-2 in bf16;
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
        (3j-c; 10 activations and 5 folds an arm);
     k. the MoE decoder and the serving path at dbrx-132b's full width
        (d_model 6144, 16 experts top-4, d_ff 10752, GQA 48/8, vocab
        100352, bf16, random weights): at 4 layers (14.27B params)
        `prefill` of 4 x 512 tokens (the flash kernel once per layer; the
        forward and the cache replay timed apart), `serve_loop` of 8
        requests over 4 slots (prompt 64, exactly 32 new tokens each;
        tokens/s, ms per batched decode step, peak memory), and
        teacher-forced `decode_step` against `forward` with `dense_topk`
        routing, held to DECODE_BOUND beside an off-by-one cache control
        (3k-a); at 2 layers `make_train_step(remat=True)`, batch 1 x 512, 3
        steps: the loss falling, the flash kernel twice per layer per step,
        s/step and peak (3k-b); the smoke dbrx LM under Fed-CHS QSGD(16),
        scanned: launches exact, uplinks at the closed form, scanned = looped
        = a second run bit for bit, card against the CPU beside controls,
        and `serve_loop` at smoke qwen3-0.6b on the card, batched = solo
        (3k-c);
     l. MLA, multi-token prediction and SSD blocks: deepseek-v3-671b at full
        width (d_model 7168, 128 heads, MLA q rank 1536, kv rank 512, rope
        64, v 128; 256 experts top-8 of d_ff 2048 and a shared expert;
        vocab 129280; bf16, random weights) at 1 layer with its MTP block
        (24.97B params) served as 3k-a serves dbrx (prefill 4 x 128,
        `serve_loop` of 8 requests over 4 slots, prompt 32, exactly 16 new
        tokens, a decode step beside its byte bound, decode against
        forward beside the off-by-one control) and its losses printed
        (main, MTP, aux) (3l-a); its 1-layer SGD step without MTP (13.36B
        params; params, grads and one new leaf at a time), the loss falling
        (3l-b); the smoke deepseek LM under Fed-CHS QSGD(16) as 3k-c holds
        smoke dbrx (3l-c); mamba2-370m whole (48 layers, 0.42B params):
        prefill 4 x 272, `serve_loop` (prompt 16, 32 new tokens), decode
        against forward beside a control that forgets the state (these at 12
        of its 48 layers), 3 SGD steps of 1 x 512, and smoke mamba2 under
        Fed-CHS QSGD(16), 2 rounds (3l-d);
     m. RG-LRU blocks, the encoder and patch embeddings (bf16, random
        weights): recurrentgemma-9b whole (38 layers, 8.53B params) served
        as 3k-a serves dbrx (decode against forward held to
        RG_DECODE_BOUND beside a control that forgets the state) and 3 SGD
        steps of 1 x 512 (3m-a); one pattern of it (3 layers) over 2 x
        2112 tokens, decode against the flash forward past the 2048-token
        window beside forget and off-by-one controls (3m-b); smoke
        recurrentgemma under Fed-CHS QSGD(16) as 3k-c holds smoke dbrx
        (3m-c); whisper-tiny whole with frames drawn from a seed (prefill
        fills the cross caches; decode against forward beside off-by-one
        and zeroed-cross controls; `serve_loop` batched = solo; the
        encoder's gradient; 3 SGD steps; `launch.train --execute` at smoke
        size; the smoke model card against CPU) (3m-d); phi-3-vision-4.2b
        whole with 576 patches drawn from a seed (the forward over patches
        and tokens; decode against the backbone's forward without them;
        the projector's gradient; SGD steps over 1 x 512 tokens and the
        patches; `launch.train --execute`; the smoke model card against
        CPU) (3m-e);
     n. the federation mesh (`repro_torch.sharding`, `launch/mesh.py`): 4
        gloo ranks sharing the card (NCCL takes one rank per card), each
        spawned process on cuda:0, a failure in any rank failing the
        script.  The reference's tiny task (16 -> 32 -> 4 MLP, 20 clients,
        4 ESs, and ragged 7/5/4/4 clusters): all four drivers, dense and
        QSGD(16), on mesh (2, 2) against the same run in this process,
        params bit for bit (or, where cuBLAS picks a product by the lane
        count, within 1e-6 of the single run's update and twice a 1-ulp
        control), ledgers equal, B1/B2 over the ranks = 4 x the
        single run's (3n-a); the LeNet task of 3a, 2 rounds, Fed-CHS
        QSGD(16) on (1, 4) and Hier-Local-QSGD QSGD(16) on (2, 2), params
        held to one card's as in 3n-a, ledgers equal, B1 = B2 = 4 ranks x rounds x compressed hops a
        round x 10 leaves, each rank's s/round and peak printed as 4 gloo
        ranks sharing one H100, not a scale-out figure (3n-b);
        `run_sweep(mesh=)` over 4 seeds, each lane bit-equal to its solo
        run (3n-c);
     o. the model mesh (`launch.steps`, `launch/mesh.py::make_debug_mesh`,
        `models/moe_shardmap.py`), 4 gloo ranks sharing the card:
        qwen3-0.6b whole in bf16 with flash (B5 on each rank's 8 query and
        4 kv heads) on (2, 2): a train round (C = 1, 2 x 512), a prefill
        (4 x 512) and 16 decode steps; on (pod 2, data 1, model 2): a
        Fed-CHS and an HFL round (C = 2, chain c on pod c); each held to
        the same step on one card in relative L2 at MESH_BOUND x the gap of
        the one-card run from weights 1 bf16 ulp apart, beside controls
        the bound must reject (one rank's wq shard zeroed; the chains not
        passed on), flash launches exact a rank; dbrx-132b's MoE FFN at
        full width (6144, 16 experts, d_ff 10752) through
        `moe_routed_shardmap` on (2, 2) against the grouped oracle
        (boundary flips beside a 1-ulp control) and on 1 rank against
        global expert choice, bit for bit; then the dry run's roofline
        terms (H100) for qwen3-0.6b's prefill and train round at (1, 1)
        beside the card's time and peak (3o-d);
  4. time each kernel at its path's shapes with CUDA events (L2 flushed
     before every launch, the card kept busy while the host enqueues it),
     beside its plain version, its bound and, for flash attention, torch's
     scaled_dot_product_attention.  Flash f32 is bounded by its 3xTF32 route
     (3 x operations at the TF32 rate) and also printed against the f32 FMA
     bound of the CUDA cores.  The packed pair is also timed at the
     comparison path's LeNet shapes (100 senders, 4-bit codes), and unpack
     -> dequantize over a whole uplink message of each path, one launch per
     leaf, and flash attention in bf16 at dbrx-132b's prefill shape and at
     phase 3m's (beside SDPA with a boolean mask).  Rows after a kernel's
     first do not enter the kernels line, which also lists each kernel's
     launches on the serving, SGD-step and federated paths of phases
     3k-3m and on 3n-b's and 3o's mesh paths, summed over the ranks
     (`launches_on_paths`); flash is also timed at 3o's per-rank heads.
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
FLASH_HEADS = ((4, 4), (8, 2), (16, 8), (16, 1))
FLASH_HDS = tuple(range(32, 257, 32))  # every head dim the kernel takes
FLASH_WINDOWS = (None, 16, 64)
FLASH_PATH = (LM_BATCH * 2, LM_SEQ, LM_SEQ, 16, 8, 128)  # B (2 clients x 2), T, S, H, Hkv, hd
FLASH_LEAN = (LM_BATCH, LM_SEQ, LM_SEQ, 16, 8, 128)  # phase 3h: one client (batch 2) at a time
# phase 3m's attention, bf16: recurrentgemma-9b's local blocks past their
# window (3m-b; MQA), phi-3-vision-4.2b's prefill over 576 patches + 128
# tokens, whisper-tiny's decoder prefill (3m-d, 3m-e)
FLASH_RG, FLASH_RG_WINDOW = (2, 2112, 2112, 16, 1, 256), 2048
FLASH_VLM = (4, 704, 704, 32, 32, 96)
FLASH_ENC = (4, 128, 128, 6, 6, 64)

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


# flash instantiations phase 3m runs, whose ptxas lines phase 1 prints
# whether or not they spill
PTXAS_NOTED = {"flash bf16, hd 256 (recurrentgemma-9b)": "flash_fwd_kernelI13__nv_bfloat16Li256E",
               "flash bf16, hd 96 (phi-3-vision-4.2b)": "flash_fwd_kernelI13__nv_bfloat16Li96E",
               "flash bf16, hd 64 (whisper-tiny)": "flash_fwd_kernelI13__nv_bfloat16Li64E"}


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
    # dbrx-132b's prefill (phase 3k-a): GQA groups of 6, hd 128, in bf16;
    # phase 3m's shapes
    for name, shape, window in (("dbrx-132b prefill", FLASH_DBRX, None),
                                ("recurrentgemma-9b past its window", FLASH_RG,
                                 FLASH_RG_WINDOW),
                                ("phi-3-vision-4.2b prefill", FLASH_VLM, None),
                                ("whisper-tiny prefill", FLASH_ENC, None),
                                ("qwen3-0.6b prefill, a rank's heads on (2, 2)", FLASH_MESH,
                                 None)):
        held(*flash_inputs(torch, gen, *shape, torch.bfloat16), True, window,
             f"{name} {shape}")
    print(f"phase 2: flash attention vs plain passed on {n_cases} cases (T,S in {FLASH_TS}, "
          f"H,Hkv in {FLASH_HEADS}, hd in {FLASH_HDS}, (causal, window) in {masks}; the LM "
          f"path's shape {FLASH_PATH}; fused-projection views and views off 16-byte "
          f"alignment; f32 + bf16), the lean path's {FLASH_LEAN}, dbrx-132b's prefill "
          f"{FLASH_DBRX}, recurrentgemma-9b's {FLASH_RG} at window {FLASH_RG_WINDOW}, "
          f"phi-3-vision-4.2b's {FLASH_VLM} and whisper-tiny's {FLASH_ENC} (bf16); max |diff| "
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
    """(result, wall ms, CUDA kernel events) of `run()` under the profiler,
    which traces the card only: host-op events would add nothing the
    kernel share reads, and summing them takes longer than the run."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
# read 12.4355, 12.4186, 12.4412, then 12.4034, 12.4197, 12.3727), 4 do (6
# until the script needed the time for phase 3m); the
# Appendix-A arms at 3e's scale keep 2 and 10 client replicas live.  A
# card-vs-CPU gap under bf16 compute is bounded by CROSS_ULPS times the CPU
# run's own gap from weights 1 bf16 ulp apart.
LEAN_MB, LEAN_ROUNDS = 1, 4
MB_ARMS = (("Hier-Local-QSGD QSGD(16)", 2), ("FedAvg", 10))
CROSS_ULPS = 2.0
BF16_ULP = 2.0**-7
F32_ULP = 2.0**-23


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
# qwen3-0.6b run.  The async arms' depth was halved (20 -> 10 activations,
# 10 -> 5 folds, the kill at 5, profiled heads of 3/1/2 steps, not 5/2/3)
# to make room for phase 3n.
ASYNC_ACTIVATIONS, ASYNC_FOLDS, ANCHOR_ACTIVATIONS, ASYNC_KILL_AT = 10, 5, 4, 5
ASYNC_GAMMA = 0.70  # benchmarks/fig_async.py's GAMMA
# the steps of each async arm that are profiled for its kernel share
ASYNC_PROFILED = {"Fed-CHS": 3, "FedAvg (FedBuff)": 1, "Hier (FedAsync)": 2}
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
            # a kernel share once, Fed-CHS's under the straggler network
            # (the PS drivers' under churn went in PR 24 to make room for
            # phase 3o: their CUPTI-profiled heads took 52 s)
            if scen == "straggler" and name == "Fed-CHS":
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


# phase 3k: the MoE decoder and the serving path.  dbrx-132b at full width
# (d_model 6144, 16 experts top-4 of d_ff 10752, GQA 48/8 heads of 128,
# vocab 100352, bf16, random weights from a seed), its depth cut to 4 layers
# for serving (14.27B params) and to 2 for the SGD step (params, grads and
# new params on one card); federated MoE at dbrx's smoke width.
MOE_ARCH = "dbrx-132b"
SERVE_LAYERS, TRAIN_LAYERS = 4, 2
PREFILL_BATCH, PREFILL_SEQ = 4, 512
SERVE = dict(requests=8, slots=4, prompt_len=64, max_new=32)
PARITY_BATCH, PARITY_SEQ = 2, 64
TRAIN_STEPS, TRAIN_SEQ, TRAIN_LR = 3, 512, 0.3
FLASH_DBRX = (PREFILL_BATCH, PREFILL_SEQ, PREFILL_SEQ, 48, 8, 128)  # prefill's attention
# teacher-forced decode against forward in bf16, relative L2 of the logits.
# The two paths round activations to bf16 at other places (the flash
# kernel's P, other product shapes), and a token whose router scores nearly
# tie may take another expert.  A 4-layer, d_model 1024 cut of the config
# read 0.039 on the CPU, and the off-by-one control 0.76.  Phase 3l-a holds
# MLA to the same bound: a 1-layer, d_model 1024 cut of deepseek-v3-671b (16
# heads, 64 experts, the full MLA dims) read 0.0098 and 0.032 on the CPU
# (two weight draws), the off-by-one control 0.45.
DECODE_BOUND = 0.125
# phase 3k-c: the first QSGD(16) round of the smoke MoE LM, card against
# CPU, over the update.  A code step is a sixteenth of a block norm, and
# the card's flash runs split TF32, so codes (and with them expert choices)
# flip where the CPU's do not: an H100 80GB HBM3 at 700 W read 0.019, the
# CPU run against itself from weights 1 + 2^-23 apart 0.0049.  The bound
# must reject the controls, all run on the CPU: QSGD with one level fewer
# (15) reads 0.56, QSGD(8) 1.08, dense uplinks 0.75, and a run that
# never updates 1.  Expert choice makes a round chaotic (a 5% smaller step
# reads 0.52), so a fault in the MoE path reads far above the bound.
# Phases 3l-c and 3l-d hold their smoke runs to it too.
MOE_QSGD_BOUND = 0.1


def moe_batch(torch, cfg, B, T, seed):
    """Tokens and labels (B, T) on the card, and, for a config with a stub
    frontend, its input drawn from `seed` on the card: frames (B, F, d) for
    an encoder-decoder, patches (B, P, 1024) for a VLM."""
    from repro_torch.data.tokens import synthetic_lm_batch

    b = {k: torch.from_numpy(v).cuda()
         for k, v in synthetic_lm_batch(cfg.vocab_size, B, T, seed=seed).items()}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.is_encoder_decoder:
        b["frames"] = torch.randn((B, cfg.num_audio_frames, cfg.d_model), generator=gen,
                                  device="cuda")
    if cfg.num_patches:
        b["patches"] = torch.randn((B, cfg.num_patches, 1024), generator=gen, device="cuda")
    return b


def teacher_forced(torch, cfg, params, batch, control=None):
    """Logits (B, T, V) of decode_step fed the prompt token by token with
    `dense_topk` routing, an encoder-decoder's cross caches first filled
    from `batch["frames"]`.  Controls: "off_by_one" writes each token after
    the first over the previous token's cache slot; "forget" decodes each
    token from empty caches (an SSD or RG-LRU model's state dropped);
    "zero_cross" leaves the cross caches zero."""
    from repro_torch.models import transformer as tf

    tokens = batch["tokens"]
    B, T = tokens.shape
    empty = tf.init_caches(cfg, B, T, enc_len=cfg.num_audio_frames, device=tokens.device)
    if cfg.is_encoder_decoder and control != "zero_cross":
        empty = tf._fill_cross_caches(cfg, params, batch, empty)
    caches, out = empty, []
    for t in range(T):
        if control == "off_by_one" and t:
            caches = tf.set_cache_len(caches, t - 1)
        elif control == "forget":
            caches = empty
        logits, caches = tf.decode_step(cfg, params, caches, tokens[:, t:t + 1],
                                        moe_method="dense_topk")
        out.append(logits.float())
    return torch.stack(out, dim=1)


def flash_layers(cfg) -> int:
    """Layers whose attention runs the flash kernel when `use_flash` is on:
    GQA attention blocks (MLA and SSD blocks run no kernel)."""
    if cfg.mla is not None:
        return 0
    return sum(cfg.block_kind(i) in ("attn", "local") for i in range(cfg.num_layers))


def decode_read_bytes(params, caches) -> int:
    """Bytes one batched decode step reads at least: every weight it uses
    (all experts, since expert choice at one token a slot gives each expert
    C = 1) and the caches, each once; not the embedding table (one row a
    slot) and not the MTP block, which decode never runs."""
    from repro_torch.utils import tree_leaves

    used = [params[k] for k in ("super", "tail", "final_norm", "lm_head") if k in params]
    return sum(t.numel() * t.element_size() for t in tree_leaves([used, caches]))


def serving_path(torch, build, label, cfg, what, prefill, serve, parity, controls, bound):
    """`prefill` of prefill = (B, T) tokens (the flash kernel once per GQA
    layer; the forward, the LM head on the last position only, and the
    cache replay timed apart), `serve_loop` (every request exactly max_new
    tokens; s per batched decode step beside its byte bound, tokens/s, peak
    memory), and teacher-forced decode against `forward` with `dense_topk`
    routing, held to `bound` beside `controls` (`teacher_forced`'s) that
    the bound must reject.  A VLM's decode never sees patches, so it is held
    against the forward of its backbone without them, as the reference's
    decode parity holds it.  Returns the params (for the phase's next
    checks)."""
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models import transformer as tf
    from repro_torch.utils import tree_leaves, tree_num_params

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = timed(torch, lambda: tf.init_params(cfg, 0, "cuda"))
    n = tree_num_params(params)
    weights_gb = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9
    print(f"phase {label}: {cfg.name} at full width ({what}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}), {cfg.num_layers} layers: {n} params ({weights_gb:.2f} GB) drawn in "
          f"{init_ms / 1e3:.2f} s")

    B, T = prefill
    b = moe_batch(torch, cfg, B, T, 0)
    with torch.no_grad():
        timed(torch, lambda: tf.forward(cfg, params, b))  # first launches, cuBLAS set-up
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        (logits, caches), prefill_ms = timed(torch, lambda: tf.prefill(cfg, params, b))
        launches = dict(build.LAUNCHES)
        PATH_LAUNCHES[f"{label} prefill"] = launches
        prefill_gb = torch.cuda.max_memory_allocated() / 1e9
        # prefill's forward (the LM head on the last position only), and
        # beside it the forward that makes all (B, T, V) logits
        _, fwd_ms = timed(torch, lambda: tf.forward(cfg, params, b, last_only=True))
        _, full_ms = timed(torch, lambda: tf.forward(cfg, params, b))
    want = dict.fromkeys(launches, 0) | {"flash_attention": flash_layers(cfg)}
    check(launches == want, f"{label} prefill launches {launches}, expected {want}")
    check(tuple(logits.shape) == (B, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"{label} prefill logits")
    lens = [t for t in tree_leaves(caches) if t.dtype == torch.int32]
    check(all(bool((t == T).all()) for t in lens),
          f"{label}: the caches do not hold the prompt")
    print(f"  prefill of {B} prompts x {T} tokens: {prefill_ms / 1e3:.3f} s; its forward "
          f"{fwd_ms:.1f} ms warm ({full_ms:.1f} ms with all {B} x {T} x {cfg.vocab_size} "
          f"logits; flash launched {launches['flash_attention']} times, once per GQA "
          f"layer), the cache replay ({T} decode steps) {(prefill_ms - fwd_ms) / 1e3:.3f} s "
          f"({(prefill_ms - fwd_ms) / T:.2f} ms a step); peak {prefill_gb:.2f} GB")
    del logits, caches

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    (done, steps), serve_ms = timed(torch, lambda: serve_loop(cfg, params, **serve))
    launches = dict(build.LAUNCHES)
    serve_gb = torch.cuda.max_memory_allocated() / 1e9
    check(sorted(done) == list(range(serve["requests"]))
          and all(len(v) == serve["max_new"] for v in done.values())
          and all(0 <= t < cfg.vocab_size for v in done.values() for t in v),
          f"{label} serve_loop: a request without exactly max_new tokens")
    check(not any(launches.values()), f"{label} serve_loop launched {launches}")
    tokens = sum(len(v) for v in done.values())
    calls = steps + serve["requests"] * serve["prompt_len"]
    # one batched decode step at serve["slots"] slots, warm, timed alone
    caches = tf.init_caches(cfg, serve["slots"], serve["prompt_len"] + serve["max_new"],
                            device="cuda")
    step_bound_ms = decode_read_bytes(params, caches) / MEM_BYTES_PER_S * 1e3
    tok = torch.zeros((serve["slots"], 1), dtype=torch.int32, device="cuda")
    with torch.no_grad():
        for _ in range(2):
            _, caches = tf.decode_step(cfg, params, caches, tok)
        steps_ms = []
        for _ in range(16):
            (_, caches), ms = timed(torch, lambda: tf.decode_step(cfg, params, caches, tok))
            steps_ms.append(ms)
    step_ms = statistics.median(steps_ms)
    print(f"  serve_loop, {serve['requests']} requests over {serve['slots']} slots, prompt "
          f"{serve['prompt_len']}, max_new {serve['max_new']}: {tokens} tokens (exactly "
          f"{serve['max_new']} a request) in {serve_ms / 1e3:.2f} s = "
          f"{tokens / serve_ms * 1e3:.1f} tokens/s; {steps} batched decode steps and "
          f"{calls - steps} teacher-forced prefill "
          f"steps ({serve_ms / calls:.2f} ms a decode_step call); a batched decode step at "
          f"{serve['slots']} slots {step_ms:.2f} ms warm (median of 16; min {min(steps_ms):.2f}; "
          f"byte bound {step_bound_ms:.2f} ms, {step_ms / step_bound_ms:.2f}x); "
          f"peak {serve_gb:.2f} GB")

    backbone = dataclasses.replace(cfg, num_patches=0)
    b = moe_batch(torch, backbone, *parity, 1)
    with torch.no_grad():
        fwd, _ = tf.forward(backbone, params, b, moe_method="dense_topk")
        fwd = fwd.float()
        dec = teacher_forced(torch, cfg, params, b)
        ctrl_rel = {c: float((teacher_forced(torch, cfg, params, b, control=c) - fwd).norm()
                             / fwd.norm()) for c in controls}
    rel = float((dec - fwd).norm() / fwd.norm())
    agree = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    print(f"  teacher-forced decode_step vs forward (dense_topk, {parity[0]} x {parity[1]} "
          f"tokens{', the backbone without patches' if cfg.num_patches else ''}): logits "
          f"{rel:.4g} apart in relative L2 (bound {bound}), max |diff| "
          f"{float((dec - fwd).abs().max()):.3g} of max |logit| {float(fwd.abs().max()):.3g}, "
          f"argmax equal at {100 * agree:.1f}% of positions; "
          + "; ".join(f"{c.replace('_', '-')} control {r:.4g}" for c, r in ctrl_rel.items()))
    check(rel <= bound and bool(torch.isfinite(dec).all()),
          f"{label}: teacher-forced decode strays from forward")
    for c, r in ctrl_rel.items():
        check(r > bound, f"{label}: the decode bound would pass the {c} control")
    return params


def moe_serving_path(torch, build):
    """Phase 3k-a: dbrx-132b at full width, 4 layers, bf16: `prefill` of
    4 x 512 tokens, `serve_loop` of 8 requests over 4 slots, and
    teacher-forced decode against `forward` held to DECODE_BOUND beside an
    off-by-one cache control (`serving_path`)."""
    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=SERVE_LAYERS, use_flash=True)
    what = (f"d_model {cfg.d_model}, {cfg.num_experts} experts top-{cfg.experts_per_token}, "
            f"d_ff {cfg.d_ff}, {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}")
    serving_path(torch, build, "3k-a", cfg, what, (PREFILL_BATCH, PREFILL_SEQ), SERVE,
                 (PARITY_BATCH, PARITY_SEQ), ("off_by_one",), DECODE_BOUND)


def train_step_path(torch, build, label, cfg, seq, lr):
    """`make_train_step(remat=True)`, batch 1 x `seq`, TRAIN_STEPS SGD steps
    on one batch: the loss finite and falling, the aux loss finite, the
    flash kernel twice per GQA layer per step (forward and the remat
    recompute), s/step and peak."""
    from repro_torch.models import transformer as tf

    params = tf.init_params(cfg, 1, "cuda")
    b = moe_batch(torch, cfg, 1, seq, 2)
    step = tf.make_train_step(cfg, remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, steps_ms = [], []
    for _ in range(TRAIN_STEPS):
        build.reset_launches()
        (params, loss), ms = timed(torch, lambda: step(params, b, lr))
        launches = dict(build.LAUNCHES)
        PATH_LAUNCHES[f"{label} SGD step"] = launches
        want = dict.fromkeys(launches, 0) | {"flash_attention": 2 * flash_layers(cfg)}
        check(launches == want, f"{label} step launches {launches}, expected {want}")
        losses.append(float(loss))
        steps_ms.append(ms)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        _, aux = tf.forward(cfg, params, b)
    print(f"phase {label}: {cfg.name} at full width, {cfg.num_layers} layers "
          f"({cfg.param_count() / 1e9:.2f}B params), make_train_step(remat=True), batch 1 x "
          f"{seq}, flash {'on' if cfg.use_flash else 'off'}, lr {lr}: losses {losses}, aux "
          f"loss after {float(aux):.5f}; s/step {[round(ms / 1e3, 3) for ms in steps_ms]}; "
          f"flash {2 * flash_layers(cfg)} launches a step; peak {peak_gb:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB")
    check(all(math.isfinite(x) for x in losses) and math.isfinite(float(aux)),
          f"{label}: non-finite loss")
    check(losses[-1] < losses[0], f"{label}: the loss did not fall")
    return {"step_s": steps_ms[-1] / 1e3, "peak_gb": peak_gb}


def moe_train_step_path(torch, build):
    """Phase 3k-b: dbrx-132b at full width, 2 layers, bf16, batch 1 x 512,
    flash on (`train_step_path`)."""
    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=TRAIN_LAYERS, use_flash=True)
    return train_step_path(torch, build, "3k-b", cfg, TRAIN_SEQ, TRAIN_LR)


def fed_lm_path(torch, build, label, cfg, rounds, grad_control):
    """`LMFedModel(cfg, flash=True)` at a smoke config under `run_fed_chs`
    with QSGD(16) uplinks, 4 clients in 2 clusters, scanned: launches
    exact, every uplink at the closed form, scanned bit-equal to looped and
    to a second run of the same seed; the same run on the card against the
    CPU's plain path, printed beside the CPU run's own gap from weights
    1 + 2^-23 apart (an expert-choice run strays from itself after its
    first round by a third or more of its update), its first round alone
    held to MOE_QSGD_BOUND beside no-update, dense-uplink, QSGD(15) and
    QSGD(8) controls, and a grad-mode run held to GRAD_BOUND beside
    `grad_control` = (name, the arch config and the step size it runs on
    the CPU), as phase 3d holds its LM."""
    from repro_torch.comm.channels import DenseChannel, QSGDChannel, channel_wire_bits
    from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs
    from repro_torch.utils import tree_leaves

    kw = dict(num_clients=4, batch_size=2, seq_len=64)
    channel = QSGDChannel(16)
    K, E = 4, 2
    config = FedCHSConfig(rounds=rounds, local_steps=K, local_epochs=E, eval_every=1,
                          channel=channel, seed=0, schedule=lambda k: 0.3)
    task = lm_task(cfg, init_on_cpu=True, **kw)
    torch.cuda.synchronize()
    build.reset_launches()
    res, ms = timed(torch, lambda: run_fed_chs(task, config))
    launches = dict(build.LAUNCHES)
    PATH_LAUNCHES[f"{label} Fed-CHS"] = launches
    leaf_sizes = [t.numel() for t in tree_leaves(res.final_params)]
    J, evals = K // E, len(res.rounds)
    n_eval_batches = len(task.source.eval_data()["tokens"])
    want = {"flash_attention": flash_layers(cfg) * (rounds * K + evals * n_eval_batches),
            "qsgd_quantize_pack": rounds * J * len(leaf_sizes),
            "qsgd_unpack_dequantize": rounds * J * len(leaf_sizes),
            "qsgd_quantize": 0, "qsgd_dequantize": 0}
    check(launches == want, f"{label} launches {launches}, expected {want}")
    d = sum(leaf_sizes)
    up = channel_wire_bits(channel, d, leaf_sizes)
    led = res.ledger
    visited = [int(e.sender.split(":")[1]) for e in led.events if e.hop == "es_to_es"]
    n_up = sum(J * len(LM_CLUSTERS[m]) for m in visited)
    check(led.messages["client_to_es"] == n_up and led.bits["client_to_es"] == n_up * up
          and all(e.n_bits == up for e in led.events if e.hop == "client_to_es"),
          f"{label}: uplinks differ from the closed form")
    looped = run_fed_chs(task, dataclasses.replace(config, scan_rounds=False))
    same_run(torch, f"{label} looped", res, looped)
    same_run(torch, f"{label} same seed", run_fed_chs(task, config), res)
    moe = (f", {cfg.num_experts} experts top-{cfg.experts_per_token}" if cfg.is_moe else "")
    print(f"phase {label}: smoke {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}"
          f"{moe}; {d} params in {len(leaf_sizes)} leaves) Fed-CHS QSGD(16), flash, {rounds} "
          f"rounds scanned in {ms / 1e3:.2f} s: launches {launches} (exact); {n_up} uplinks of "
          f"{up} bits (the closed form); scanned = looped = a second run, bit for bit; "
          f"perplexity {res.test_acc}")

    # card against CPU.  Expert choice gives each expert the top half of the
    # tokens, so a token at the boundary switches experts under any change of
    # float order, and QSGD codes flip with it: after its first round the run
    # strays even from itself.  Each QSGD comparison prints the CPU run
    # against itself from weights 1 + 2^-23 apart; the whole run's gap is
    # printed beside it, the first round's is held to MOE_QSGD_BOUND.
    def cpu_run(conf, c=cfg, scale=1.0):
        return run_fed_chs(lm_task(c, device="cpu", init_on_cpu=True, scale=scale, **kw), conf)

    p0 = lm_task(cfg, device="cpu", init_on_cpu=True, **kw).init_params()

    def gaps(name, on_card, conf, controls=()):
        on_cpu, twin = cpu_run(conf), cpu_run(conf, scale=1 + F32_ULP)
        _, upd_rel, upd, gap = card_vs_cpu(torch, on_card, on_cpu, p0)
        _, ulp_rel, _, _ = card_vs_cpu(torch, twin, on_cpu, p0)
        b = flat_params(torch, on_cpu.final_params)
        update = float((b - flat_params(torch, p0)).norm())
        read = {c_name: float((flat_params(torch, c_run.final_params) - b).norm()) / update
                for c_name, c_run in controls}
        print(f"  {name}, card vs CPU plain path: params gap {upd_rel:.3g} of the update (which "
              f"is {upd:.3g} of p_T), largest perplexity gap {gap:.3g}; the CPU run against "
              f"itself from weights 1 + 2^-23 apart: {ulp_rel:.3g}"
              + "".join(f"; {c_name} control {r:.3g}" for c_name, r in read.items()))
        return upd_rel, read

    gaps(f"the {rounds}-round QSGD(16) run above", res, config)
    one = dataclasses.replace(config, rounds=1)
    upd_rel, read = gaps(
        f"its first round alone (bound {MOE_QSGD_BOUND})", run_fed_chs(task, one), one,
        [("no-update", cpu_run(dataclasses.replace(one, schedule=lambda k: 0.0))),
         ("dense-uplink", cpu_run(dataclasses.replace(one, channel=DenseChannel()))),
         ("QSGD(15)", cpu_run(dataclasses.replace(one, channel=QSGDChannel(15)))),
         ("QSGD(8)", cpu_run(dataclasses.replace(one, channel=QSGDChannel(8))))])
    check(upd_rel <= MOE_QSGD_BOUND, f"{label}: the card's first round strays from the CPU's")
    for c_name, r in read.items():
        check(r > MOE_QSGD_BOUND, f"{label}: the bound would pass the {c_name} control")
    grad = FedCHSConfig(rounds=2, local_steps=4, local_epochs=1, eval_every=1,
                        channel=DenseChannel(), seed=0, schedule=lambda k: 0.3)
    on_card = run_fed_chs(task, grad)
    on_cpu = cpu_run(grad)
    _, upd_rel, upd, _ = card_vs_cpu(torch, on_card, on_cpu, p0)
    ctrl_name, ctrl_cfg, ctrl_lr = grad_control
    ctrl = cpu_run(dataclasses.replace(grad, schedule=lambda k: ctrl_lr), ctrl_cfg)
    _, ctrl_rel, _, _ = card_vs_cpu(torch, ctrl, on_cpu, p0)
    print(f"  grad mode (dense uplinks, E=1, 2 rounds), card vs CPU plain path: params gap "
          f"{upd_rel:.3g} of the update (which is {upd:.3g} of p_T; bound {GRAD_BOUND:g}); "
          f"{ctrl_name} reads {ctrl_rel:.3g}")
    check(upd_rel <= GRAD_BOUND, f"{label}: the card's grad-mode run strays from the CPU run")
    check(ctrl_rel > GRAD_BOUND, f"{label}: the grad-mode bound would pass the {ctrl_name}")


def moe_fed_path(torch, build):
    """Phase 3k-c: smoke dbrx-132b under Fed-CHS QSGD(16), 3 rounds
    (`fed_lm_path`, with a wrong-mask grad-mode control); then `serve_loop`
    at smoke qwen3-0.6b on the card, solo equal to batched."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models import transformer as tf

    cfg = smoke_config(MOE_ARCH)
    fed_lm_path(torch, build, "3k-c", cfg, 3, (
        "wrong-mask control on the CPU (window 16)",
        dataclasses.replace(cfg, block_pattern=("local",), sliding_window=16), 0.3))
    qcfg = smoke_config(LM_ARCH)
    qparams = tf.init_params(qcfg, 0, "cuda")
    batched, _ = serve_loop(qcfg, qparams, requests=6, slots=4, prompt_len=6, max_new=8)
    solo, _ = serve_loop(qcfg, qparams, requests=6, slots=1, prompt_len=6, max_new=8)
    check(batched == solo and all(len(v) == 8 for v in solo.values()),
          "3k-c: serve_loop batched differs from solo on the card")
    print(f"  serve_loop at smoke {LM_ARCH} on the card: 6 requests over 4 slots equal to "
          f"1 slot, token for token, 8 tokens each")


# phase 3l: MLA and multi-token prediction through deepseek-v3-671b at full
# width (d_model 7168, 128 heads, MLA q rank 1536, kv rank 512, rope 64, v
# 128; 256 routed experts top-8 of d_ff 2048 and a shared expert; vocab
# 129280; bf16, random weights), cut to 1 layer: served with its MTP block
# (24.97B params), its SGD step without it (13.36B); the smoke deepseek LM
# under Fed-CHS; then SSD blocks through mamba2-370m at full size.
MLA_ARCH, SSD_ARCH = "deepseek-v3-671b", "mamba2-370m"
MLA_PREFILL, MLA_PARITY, MLA_TRAIN_SEQ = (4, 128), (2, 32), 256
MLA_SERVE = dict(requests=8, slots=4, prompt_len=32, max_new=16)
# the SSD decode step is host-bound (66-95 ms at 48 layers on an H100 80GB
# HBM3 at 700 W), so the prompts decoded token by token are cut: the
# prefill to 272 tokens (two chunks of 256, the second ragged), the serving
# prompts to 16
SSD_PREFILL, SSD_PARITY, SSD_TRAIN_SEQ = (4, 272), (2, 64), 512
# and the serving checks run 12 of its 48 layers (the SGD step all 48), so
# the whole script keeps within its time limit beside phase 3m
SSD_SERVE_LAYERS = 12
SSD_SERVE = dict(requests=8, slots=4, prompt_len=16, max_new=32)
# mamba2-370m's teacher-forced decode against its chunked forward in bf16:
# 48 layers round the conv and the residual stream at other places (the
# forward sums the conv's bf16 products, decode contracts the history in
# f32).  The whole model on the CPU read 0.088 and 0.093 (two weight
# draws), argmax equal at 76-81% of positions; decoding every token from an
# empty state read 1.38.
SSD_DECODE_BOUND = 0.3


def mla_serving_path(torch, build):
    """Phase 3l-a: deepseek-v3-671b at full width, 1 layer, with its MTP
    block, bf16: `serving_path` (prefill 4 x 128, `serve_loop` 8 requests
    over 4 slots, prompt 32, 16 new tokens, decode against forward at
    DECODE_BOUND beside an off-by-one control), then `loss_fn` with MTP:
    the main, MTP and aux losses, their sum equal to `loss_fn`."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import cross_entropy_loss

    cfg = dataclasses.replace(get_config(MLA_ARCH), num_layers=1)
    m = cfg.mla
    what = (f"d_model {cfg.d_model}, {cfg.num_heads} heads, MLA q rank {m.q_lora_rank}, kv "
            f"rank {m.kv_lora_rank}, nope {m.qk_nope_head_dim} + rope {m.qk_rope_head_dim}, v "
            f"{m.v_head_dim}; {cfg.num_experts} experts top-{cfg.experts_per_token} of d_ff "
            f"{cfg.d_ff} and {cfg.num_shared_experts} shared; MTP depth {cfg.mtp_depth}")
    params = serving_path(torch, build, "3l-a", cfg, what, MLA_PREFILL, MLA_SERVE, MLA_PARITY,
                          ("off_by_one",), DECODE_BOUND)
    b = moe_batch(torch, cfg, 2, 64, 3)
    with torch.no_grad():
        logits, aux = tf.forward(cfg, params, b)
        main = cross_entropy_loss(logits, b["labels"])
        mtp = tf._mtp_loss(cfg, params, b)
        total = tf.loss_fn(cfg, params, b)
    parts = float(main + 0.3 * mtp + aux)
    print(f"  loss_fn with MTP (2 x 64 tokens): main {float(main):.5f}, MTP {float(mtp):.5f}, "
          f"aux {float(aux):.6f}; main + 0.3 x MTP + aux = {parts:.5f}, loss_fn "
          f"{float(total):.5f}")
    check(all(math.isfinite(float(x)) for x in (main, mtp, aux, total)),
          "3l-a: a non-finite loss")
    check(abs(float(total) - parts) <= 1e-5 * abs(parts), "3l-a: loss_fn is not its parts")


def mla_train_step_path(torch, build):
    """Phase 3l-b: deepseek-v3-671b at full width, 1 layer, no MTP block,
    bf16, batch 1 x 256 (`train_step_path`): params, grads and one new
    leaf must fit beside each other."""
    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config(MLA_ARCH), num_layers=1, mtp_depth=0)
    return train_step_path(torch, build, "3l-b", cfg, MLA_TRAIN_SEQ, TRAIN_LR)


def mla_fed_path(torch, build):
    """Phase 3l-c: smoke deepseek-v3-671b (MLA, MTP, expert choice) under
    Fed-CHS QSGD(16), 3 rounds (`fed_lm_path`): B1 and B2 on the MLA and
    MTP leaves.  MLA ignores the window of "local" blocks, so the grad-mode
    control halves the rope base instead."""
    from repro_torch.configs.registry import smoke_config

    cfg = smoke_config(MLA_ARCH)
    fed_lm_path(torch, build, "3l-c", cfg, 3, (
        "wrong-position control on the CPU (rope base halved)",
        dataclasses.replace(cfg, rope_theta=cfg.rope_theta / 2), 0.3))


def ssd_path(torch, build):
    """Phase 3l-d: mamba2-370m at full width (bf16): `serving_path` at 12 of
    its 48 layers (prefill 4 x 272, `serve_loop` 8 requests over 4 slots,
    prompt 16, 32 new tokens, decode against forward at SSD_DECODE_BOUND
    beside a control that forgets the state), `make_train_step` at all 48
    layers, 3 steps of 1 x 512; then the
    smoke mamba2 under Fed-CHS QSGD(16), 2 rounds (`fed_lm_path`, with a 5%
    smaller step as the grad-mode control)."""
    from repro_torch.configs.registry import get_config, smoke_config

    cfg = get_config(SSD_ARCH)
    served = dataclasses.replace(cfg, num_layers=SSD_SERVE_LAYERS)
    what = (f"d_model {cfg.d_model}, state {cfg.ssm_state}, inner {cfg.ssm_expand * cfg.d_model}"
            f" in heads of {cfg.ssm_head_dim}, conv {cfg.ssm_conv}, chunk {cfg.ssm_chunk}")
    params = serving_path(torch, build, "3l-d", served, what, SSD_PREFILL, SSD_SERVE,
                          SSD_PARITY, ("forget",), SSD_DECODE_BOUND)
    del params
    torch.cuda.empty_cache()
    train_step_path(torch, build, "3l-d", cfg, SSD_TRAIN_SEQ, TRAIN_LR)
    torch.cuda.empty_cache()
    small = smoke_config(SSD_ARCH)
    fed_lm_path(torch, build, "3l-d", small, 2, ("a 5% smaller step on the CPU", small, 0.285))


# phase 3m: RG-LRU blocks through recurrentgemma-9b (d_model 4096, LRU width
# 4096, 16 heads of 256 with one KV head, window 2048, d_ff 12288 GeLU,
# vocab 256000; rglru, rglru, local), the encoder, cross-attention caches and
# stub frames through whisper-tiny (4 + 4 layers, d_model 384, 1500 frames),
# and stub patch embeddings through phi-3-vision-4.2b (32 layers, d_model
# 3072, 32 heads of 96, 576 patches of width 1024); bf16, random weights.
RG_ARCH, ENC_ARCH, VLM_ARCH = "recurrentgemma-9b", "whisper-tiny", "phi-3-vision-4.2b"
RG_PREFILL, RG_PARITY, RG_TRAIN_SEQ = (4, 128), (2, 64), 512
RG_SERVE = dict(requests=8, slots=4, prompt_len=16, max_new=32)
RG_WRAP_LAYERS, RG_WRAP = 3, (2, 2112)  # one pattern; 64 tokens past the window
ENC_PREFILL, ENC_PARITY, ENC_TRAIN_SEQ = (4, 128), (2, 64), 256
ENC_SERVE = dict(requests=8, slots=4, prompt_len=16, max_new=32)
VLM_PREFILL, VLM_PARITY, VLM_TRAIN_SEQ = (4, 128), (2, 64), 512
VLM_SERVE = dict(requests=8, slots=4, prompt_len=16, max_new=32)
# recurrentgemma's teacher-forced decode against its flash forward in bf16:
# the conv sums its bf16 products in another order on each side, the
# flash kernel rounds P to bf16.  A 6-layer, d_model 1024 cut read 0.0116
# and 0.0115 on the CPU (two weight draws), a 3-layer cut past a window of
# 32 0.0098.  Only a third of the layers attend, so the off-by-one cache
# control is weak (0.12-0.13 on the 6-layer cut, 0.098 on the 3-layer
# one) and DECODE_BOUND would pass it: RG-LRU paths take this tighter bound.
RG_DECODE_BOUND = 0.06
# phase 3m-d/e: the smoke models (f32) card against CPU, loss and every
# gradient; the card's flash runs split TF32 and its products sum in other
# orders.  Controls on the CPU: the stub inputs (frames, patches) zeroed.
SMOKE_BOUND = 1e-4
# the kernel launches of every path, by phase (serving_path, train_step_path,
# fed_lm_path and the 3m phases fill it), for the kernels line
PATH_LAUNCHES: dict[str, dict[str, int]] = {}


def rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm())


def rglru_serving_path(torch, build):
    """Phase 3m-a: recurrentgemma-9b whole (38 layers, bf16): `serving_path`
    (prefill 4 x 128, `serve_loop` 8 requests over 4 slots, prompt 16, 32
    new tokens, decode against forward at RG_DECODE_BOUND beside a control
    that forgets the state; 3m-b holds the off-by-one control), then
    `make_train_step`, 3 steps of 1 x 512."""
    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config(RG_ARCH), use_flash=True)
    what = (f"d_model {cfg.d_model}, LRU width {cfg.lru_width}, {cfg.num_heads}/"
            f"{cfg.num_kv_heads} heads of {cfg.head_dim}, window {cfg.sliding_window}, d_ff "
            f"{cfg.d_ff}, pattern {'/'.join(cfg.block_pattern)}")
    params = serving_path(torch, build, "3m-a", cfg, what, RG_PREFILL, RG_SERVE, RG_PARITY,
                          ("forget",), RG_DECODE_BOUND)
    del params
    torch.cuda.empty_cache()
    train_step_path(torch, build, "3m-a", cfg, RG_TRAIN_SEQ, TRAIN_LR)


def rglru_window_path(torch, build):
    """Phase 3m-b: recurrentgemma-9b at full width cut to one pattern (rglru,
    rglru, local), bf16: teacher-forced decode against the flash forward
    over 2 x 2112 tokens, where the 2048-slot ring buffer wraps and the
    kernel's window takes effect; held at RG_DECODE_BOUND over all positions
    and over those past the window, beside a control that forgets the
    state and an off-by-one cache control (read over the first 64
    positions, where one key of the few visible ones is a large share)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_config(RG_ARCH), num_layers=RG_WRAP_LAYERS, use_flash=True)
    params = tf.init_params(cfg, 0, "cuda")
    B, T = RG_WRAP
    W = cfg.sliding_window
    b = moe_batch(torch, cfg, B, T, 4)
    torch.cuda.synchronize()
    build.reset_launches()
    with torch.no_grad():
        (fwd, _), fwd_ms = timed(torch, lambda: tf.forward(cfg, params, b,
                                                           moe_method="dense_topk"))
        launches = dict(build.LAUNCHES)
        PATH_LAUNCHES["3m-b forward"] = launches
        fwd = fwd.float()
        dec, dec_ms = timed(torch, lambda: teacher_forced(torch, cfg, params, b))
        forget = teacher_forced(torch, cfg, params, b, control="forget")
        shifted = teacher_forced(torch, cfg, params, {"tokens": b["tokens"][:, :64]},
                                 control="off_by_one")
        unwindowed = dataclasses.replace(cfg, block_pattern=("rglru", "rglru", "attn"))
        full = tf.forward(unwindowed, params, b, moe_method="dense_topk")[0].float()
    want = dict.fromkeys(launches, 0) | {"flash_attention": flash_layers(cfg)}
    check(launches == want, f"3m-b forward launches {launches}, expected {want}")
    rel, past = rel_l2(dec, fwd), rel_l2(dec[:, W:], fwd[:, W:])
    ctrl, shift = rel_l2(forget, fwd), rel_l2(shifted, fwd[:, :64])
    window_effect = rel_l2(full[:, W:], fwd[:, W:])
    print(f"phase 3m-b: {cfg.name} at full width, one pattern ({cfg.num_layers} layers, "
          f"{cfg.param_count() / 1e9:.2f}B params), {B} x {T} tokens, window {W}: the flash "
          f"forward {fwd_ms:.1f} ms (flash {launches['flash_attention']} launch), "
          f"{T} teacher-forced decode steps {dec_ms / 1e3:.2f} s ({dec_ms / T:.2f} ms a step); "
          f"decode vs forward {rel:.4g} in relative L2 over all positions, {past:.4g} over the "
          f"{T - W} past the window (bound {RG_DECODE_BOUND}), argmax equal at "
          f"{100 * float((dec.argmax(-1) == fwd.argmax(-1)).float().mean()):.1f}%; "
          f"forget control {ctrl:.4g}; off-by-one control {shift:.4g} over the first 64 "
          f"positions; the forward without the window reads {window_effect:.4g} from the "
          f"windowed one past it")
    check(rel <= RG_DECODE_BOUND and past <= RG_DECODE_BOUND and bool(torch.isfinite(dec).all()),
          "3m-b: teacher-forced decode strays from the windowed forward")
    check(ctrl > RG_DECODE_BOUND and shift > RG_DECODE_BOUND,
          "3m-b: the decode bound would pass a control")


def rglru_fed_path(torch, build):
    """Phase 3m-c: smoke recurrentgemma-9b under Fed-CHS QSGD(16), 2 rounds
    (`fed_lm_path`): B1 and B2 on the RG-LRU leaves, the f32 `lambda` and
    `conv_w` included, B5 on the local block; the grad-mode control halves
    the window."""
    from repro_torch.configs.registry import smoke_config

    cfg = smoke_config(RG_ARCH)
    fed_lm_path(torch, build, "3m-c", cfg, 2, (
        "wrong-window control on the CPU (window halved)",
        dataclasses.replace(cfg, sliding_window=cfg.sliding_window // 2), 0.3))


def subtree_grads(torch, label, cfg, params, key):
    """The gradient of `params[key]` (the encoder or the projector) alone,
    on a 1 x 128 batch with remat: every leaf finite and nonzero."""
    from repro_torch.models import transformer as tf
    from repro_torch.utils import tree_leaves

    b = moe_batch(torch, cfg, 1, 128, 5)
    g = torch.func.grad(lambda sub: tf.loss_fn(cfg, {**params, key: sub}, b, remat=True))(
        params[key])
    leaves = tree_leaves(g)
    norms = [float(t.float().norm()) for t in leaves]
    print(f"  {label}: the {key}'s gradient (1 x 128 tokens, remat on): {len(leaves)} leaves, "
          f"L2 norms {min(norms):.4g} to {max(norms):.4g}")
    check(all(math.isfinite(n) and n > 0 for n in norms),
          f"{label}: the {key}'s gradient is zero or not finite")


def launcher_path(torch, label, arch):
    """`repro_torch.launch.train --execute` at the arch's smoke size on the
    card, in this process: 3 rounds, each printed loss finite."""
    import contextlib
    import io

    from repro_torch.launch import train as train_launch

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_launch.main(["--arch", arch, "--execute", "--rounds", "3", "--batch", "2",
                           "--seq", "16"])
    losses = [float(line.split()[3]) for line in out.getvalue().splitlines()
              if line.startswith("round ")]
    print(f"  {label}: `launch.train --execute --arch {arch}` (smoke, 3 rounds, zero "
          f"{'frames' if arch == ENC_ARCH else 'patches'}) losses {losses}")
    check(len(losses) == 3 and all(math.isfinite(x) for x in losses),
          f"{label}: train --execute printed {losses}")


def smoke_vs_cpu(torch, label, arch, stub):
    """The smoke model (f32) with its stub inputs drawn from a seed: loss and
    every gradient on the card (flash on) against the CPU's plain path,
    held to SMOKE_BOUND beside a CPU control with the stub input zeroed."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import transformer as tf
    from repro_torch.utils import tree_leaves, tree_map

    cfg = dataclasses.replace(smoke_config(arch), use_flash=True)
    params = tf.init_params(cfg, 0, "cpu")
    gen = torch.Generator().manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=gen, dtype=torch.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    width = cfg.d_model if stub == "frames" else 1024
    length = cfg.num_audio_frames if stub == "frames" else cfg.num_patches
    b[stub] = torch.randn((2, length, width), generator=gen)

    def grads_of(p, batch):
        g, loss = torch.func.grad_and_value(lambda q: tf.loss_fn(cfg, q, batch))(p)
        return torch.cat([t.reshape(-1).cpu() for t in tree_leaves(g)]), float(loss)

    g_cpu, l_cpu = grads_of(params, b)
    g_card, l_card = grads_of(tree_map(lambda t: t.cuda(), params),
                              {k: v.cuda() for k, v in b.items()})
    g_ctrl, _ = grads_of(params, dict(b, **{stub: torch.zeros_like(b[stub])}))
    gap, ctrl = rel_l2(g_card, g_cpu), rel_l2(g_ctrl, g_cpu)
    print(f"  {label}: smoke {arch} (f32, flash on the card) with {stub}, card vs CPU plain "
          f"path: loss {l_card:.6f} vs {l_cpu:.6f}, gradients {gap:.3g} apart in relative L2 "
          f"(bound {SMOKE_BOUND:g}); {stub}-zeroed control {ctrl:.3g}")
    check(abs(l_card - l_cpu) <= SMOKE_BOUND * abs(l_cpu) and gap <= SMOKE_BOUND,
          f"{label}: the smoke model on the card strays from the CPU")
    check(ctrl > SMOKE_BOUND, f"{label}: the bound would pass the {stub}-zeroed control")


def whisper_path(torch, build):
    """Phase 3m-d: whisper-tiny whole (4 decoder and 4 encoder layers, bf16,
    frames (B, 1500, 384) from a seed): `serving_path` (prefill 4 x 128 with
    the cross caches filled, `serve_loop`, decode against forward at
    DECODE_BOUND beside an off-by-one control and zeroed cross caches),
    `serve_loop` batched equal to solo, the encoder's gradient, 3 SGD steps
    of 1 x 256, `launch.train --execute` at smoke size, and the smoke model
    card against CPU."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve_loop

    cfg = dataclasses.replace(get_config(ENC_ARCH), use_flash=True)
    what = (f"d_model {cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, d_ff "
            f"{cfg.d_ff}, {cfg.encoder_layers} encoder layers over {cfg.num_audio_frames} "
            f"frames")
    params = serving_path(torch, build, "3m-d", cfg, what, ENC_PREFILL, ENC_SERVE, ENC_PARITY,
                          ("off_by_one", "zero_cross"), DECODE_BOUND)
    batched, _ = serve_loop(cfg, params, requests=6, slots=4, prompt_len=6, max_new=8)
    solo, _ = serve_loop(cfg, params, requests=6, slots=1, prompt_len=6, max_new=8)
    check(batched == solo and all(len(v) == 8 for v in solo.values()),
          "3m-d: serve_loop batched differs from solo on the card")
    print("  3m-d: serve_loop, 6 requests over 4 slots equal to 1 slot, token for token")
    subtree_grads(torch, "3m-d", cfg, params, "encoder")
    del params
    torch.cuda.empty_cache()
    train_step_path(torch, build, "3m-d", cfg, ENC_TRAIN_SEQ, TRAIN_LR)
    launcher_path(torch, "3m-d", ENC_ARCH)
    smoke_vs_cpu(torch, "3m-d", ENC_ARCH, "frames")


def vlm_path(torch, build):
    """Phase 3m-e: phi-3-vision-4.2b whole (32 layers, bf16, 576 patches of
    width 1024 from a seed): `serving_path` (prefill 4 x 128 tokens after
    the patches, the flash kernel over 704 positions; `serve_loop`; decode
    against the backbone's forward without the patches at DECODE_BOUND
    beside an off-by-one control), the projector's gradient, 3 SGD steps of
    1 x 512 tokens plus the patches, `launch.train --execute` at smoke size,
    and the smoke model card against CPU."""
    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config(VLM_ARCH), use_flash=True)
    what = (f"d_model {cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, d_ff "
            f"{cfg.d_ff}, {cfg.num_patches} patches")
    params = serving_path(torch, build, "3m-e", cfg, what, VLM_PREFILL, VLM_SERVE, VLM_PARITY,
                          ("off_by_one",), DECODE_BOUND)
    subtree_grads(torch, "3m-e", cfg, params, "projector")
    del params
    torch.cuda.empty_cache()
    train_step_path(torch, build, "3m-e", cfg, VLM_TRAIN_SEQ, TRAIN_LR)
    launcher_path(torch, "3m-e", VLM_ARCH)
    smoke_vs_cpu(torch, "3m-e", VLM_ARCH, "patches")


# phase 3n: the federation mesh.  One card, so 4 gloo ranks share it
# (NCCL refuses two ranks on one card): the sharded bodies, the padding,
# the global-slot keys and B1/B2 per rank on CUDA tensors, not a scale-out
# speed.  3n-a: the reference's tiny task (16 -> 32 -> 4 MLP, 20 clients, 4
# ESs, and ragged 7/5/4/4 clusters), every driver on a (2, 2) mesh against
# the same run in this process.  3n-b: the Appendix-A LeNet scale, Fed-CHS
# on (1, 4) (10 clients pad to 12, 3 a rank) and Hier-Local-QSGD on (2, 2),
# against single-card runs.  3n-c: `run_sweep(mesh=)`, 4 seeds on 4 ranks.
MESH_RANKS = 4
MESH_LENET_ROUNDS = 1  # 2 until PR 24 (room for phase 3o)
TINY_CASES = [  # (name, driver, config fields, ragged clusters)
    ("Fed-CHS grad", "fed_chs", dict(rounds=6, eval_every=3), False),
    ("Fed-CHS dense", "fed_chs", dict(rounds=6, local_steps=4, local_epochs=2, eval_every=3),
     False),
    ("Fed-CHS QSGD(16)", "fed_chs", dict(rounds=6, local_steps=4, local_epochs=2,
                                         qsgd_levels=16, eval_every=3), False),
    ("FedAvg dense", "fedavg", dict(rounds=4, local_steps=4, eval_every=2), False),
    ("FedAvg QSGD(16)", "fedavg", dict(rounds=4, local_steps=4, eval_every=2, qsgd_levels=16),
     False),
    ("WRWGD", "wrwgd", dict(rounds=6, local_steps=4, eval_every=3), False),
    ("Hier dense", "hier", dict(rounds=4, local_steps=4, local_epochs=2, eval_every=2,
                                qsgd_levels=None), False),
    ("Hier QSGD(16)", "hier", dict(rounds=4, local_steps=4, local_epochs=2, eval_every=2,
                                   qsgd_levels=16), False),
    ("ragged Fed-CHS QSGD(16)", "fed_chs", dict(rounds=4, local_steps=4, local_epochs=2,
                                                qsgd_levels=16, eval_every=2, seed=1), True),
    ("ragged Hier QSGD(16)", "hier", dict(rounds=2, local_steps=4, local_epochs=2,
                                          qsgd_levels=16, eval_every=1, seed=1), True),
]
SWEEP_SEEDS = (0, 5, 6, 9)


def driver(name):
    from repro_torch.core.baselines import (
        FedAvgConfig,
        HierLocalQSGDConfig,
        WRWGDConfig,
        run_fedavg,
        run_hier_local_qsgd,
        run_wrwgd,
    )
    from repro_torch.core.fed_chs import FedCHSConfig, run_fed_chs

    return {"fed_chs": (run_fed_chs, FedCHSConfig), "fedavg": (run_fedavg, FedAvgConfig),
            "wrwgd": (run_wrwgd, WRWGDConfig),
            "hier": (run_hier_local_qsgd, HierLocalQSGDConfig)}[name]


def tiny_task(torch, ragged=False, ulp=False):
    """tests/test_torch_sharding.py's tiny task on the card (data and
    weights from numpy seeds); `ulp` nudges every weight one ulp up."""
    import numpy as np

    from repro_torch.core.simulation import FLTask
    from repro_torch.data import Dataset, assign_clusters, dirichlet_partition
    from repro_torch.data.synthetic import DatasetSpec
    from repro_torch.models.classifier import Classifier

    rng = np.random.default_rng(0)
    train_y = rng.integers(0, 4, 400).astype(np.int32)
    test_y = rng.integers(0, 4, 80).astype(np.int32)
    protos = rng.normal(size=(4, 4, 4, 1)).astype(np.float32)
    train_x = (protos[train_y] + 0.3 * rng.normal(size=(400, 4, 4, 1))).astype(np.float32)
    test_x = (protos[test_y] + 0.3 * rng.normal(size=(80, 4, 4, 1))).astype(np.float32)
    w = np.random.default_rng(1)
    weights = {"fc1": {"w": (w.normal(size=(16, 32)) * np.sqrt(2 / 16)).astype(np.float32),
                       "b": np.zeros(32, np.float32)},
               "out": {"w": (w.normal(size=(32, 4)) * np.sqrt(2 / 32)).astype(np.float32),
                       "b": np.zeros(4, np.float32)}}
    if ulp:
        weights = {k: {n: np.nextafter(a, np.float32(np.inf)) for n, a in v.items()}
                   for k, v in weights.items()}

    def init(seed=0, device=None):
        return {k: {n: torch.from_numpy(a.copy()).to(device) for n, a in v.items()}
                for k, v in weights.items()}

    def apply(p, x):
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(x @ p["fc1"]["w"] + p["fc1"]["b"])
        return x @ p["out"]["w"] + p["out"]["b"]

    ds = Dataset(DatasetSpec("tiny", (4, 4, 1), 4, 400, 80), train_x, train_y, test_x, test_y)
    clients = dirichlet_partition(train_y, 20, 0.6, seed=0)
    clusters = ([list(range(0, 7)), list(range(7, 12)), list(range(12, 16)), list(range(16, 20))]
                if ragged else assign_clusters(20, 4, seed=0))
    return FLTask(Classifier("tiny-mlp", init, apply, 4), ds, clients, clusters, batch_size=8,
                  seed=0)


def lenet_appendix_task(torch, ulp=False):
    """Phase 3a's task: LeNet-MNIST, 100 clients in 10 ESs, batch 32."""
    from repro_torch.core.simulation import FLTask
    from repro_torch.data.partition import assign_clusters, dirichlet_partition
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.models.classifier import make_classifier

    ds = make_dataset("mnist", seed=0)
    model = make_classifier("lenet", "mnist", ds.spec.image_shape, 10)
    if ulp:
        init0 = model.init

        def init(seed=0, device=None):
            p = init0(seed, device)
            return {k: {n: torch.nextafter(a, torch.full_like(a, math.inf)) for n, a in v.items()}
                    for k, v in p.items()}

        model = dataclasses.replace(model, init=init)
    return FLTask(model, ds, dirichlet_partition(ds.train_y, 100, 0.6, seed=0),
                  assign_clusters(100, 10, seed=0), batch_size=32, seed=0)


def lenet_mesh_cases():
    """3n-b: (name, driver, config fields, mesh shape, uplink hops a round)."""
    base = dict(rounds=MESH_LENET_ROUNDS, local_steps=MAIN_K, local_epochs=MAIN_E,
                qsgd_levels=16, eval_every=10**6, seed=0)
    return [("Fed-CHS QSGD(16)", "fed_chs", base, (1, 4), MAIN_K // MAIN_E),
            ("Hier-Local-QSGD QSGD(16)", "hier", base, (2, 2), MAIN_K // MAIN_E + 1)]


def run_summary(torch, res) -> dict:
    """A run's params (host copies), logs and ledger."""
    from repro_torch.utils import tree_leaves

    led = res.ledger
    return {"params": [a.detach().cpu() for a in tree_leaves(res.final_params)],
            "rounds": list(res.rounds), "test_acc": list(res.test_acc),
            "train_loss": list(res.train_loss), "bits": dict(led.bits),
            "messages": dict(led.messages), "events": list(led.events),
            "history": led.history, "total_bits": led.total_bits()}


def summary_gap(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a["params"], b["params"]))


def mesh_rank(rank: int, part: str) -> dict:
    """One rank of phase 3n, in its own process on the card."""
    import torch

    from repro_torch.core import engine
    from repro_torch.core.sweep import run_sweep
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_federation_mesh
    from repro_torch.utils import resolve_device

    torch.cuda.set_device(0)
    resolve_device("cuda")  # full f32 products, as the parent runs them
    out = {}
    if part == "tiny":
        mesh = make_federation_mesh(2, 2)
        check(mesh.size == MESH_RANKS and mesh.device == torch.device("cuda", 0),
              f"rank {rank}: mesh {mesh.shape} on {mesh.device}")
        tasks = {False: tiny_task(torch), True: tiny_task(torch, ragged=True)}
        for name, drv, fields, ragged in TINY_CASES:
            run, cls = driver(drv)
            build.reset_launches()
            res = run(tasks[ragged], cls(**fields, mesh=mesh))
            out[name] = dict(run_summary(torch, res), launches=dict(build.LAUNCHES),
                             executor=engine.LAST_STATS["executor"])
        run, cls = driver("fedavg")
        build.reset_launches()
        swept = run_sweep(tasks[False], cls(rounds=3, local_steps=4, qsgd_levels=16,
                                            eval_every=1), SWEEP_SEEDS, mesh=mesh)
        out["sweep"] = [run_summary(torch, r) for r in swept]
        out["sweep_launches"] = dict(build.LAUNCHES)
        return out
    task = lenet_appendix_task(torch)
    for name, drv, fields, shape, _ in lenet_mesh_cases():
        mesh = make_federation_mesh(*shape)
        run, cls = driver(drv)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        res = run(task, cls(**fields, mesh=mesh))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[name] = dict(run_summary(torch, res), launches=dict(build.LAUNCHES),
                         s_per_round=secs / fields["rounds"],
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         executor=engine.LAST_STATS["executor"])
    return out


def spawn_mesh(torch, part: str) -> list:
    """`mesh_rank(part)` on MESH_RANKS gloo ranks sharing the card; a
    failure in any rank fails the phase."""
    from repro_torch.launch.mesh import spawn_ranks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the parent's cached blocks go back to the card
    t0 = time.perf_counter()
    try:
        out = spawn_ranks(mesh_rank, MESH_RANKS, part)
    except RuntimeError as e:
        fail(f"phase 3n ({part}): a rank failed:\n{e}")
    print(f"  [3n: {MESH_RANKS} ranks of '{part}' in {time.perf_counter() - t0:.1f} s, "
          f"process start included]")
    return out


def hold_mesh_gap(label, gap, single, p0, control) -> str:
    """A mesh run's params against the single card's run: bit-equal, or
    else within 1e-6 of the single run's update (max |params - p0|), as
    the CPU and card tests hold them, and within twice the 1-ulp control
    `control()`.  Returns the note to print."""
    if gap == 0.0:
        return "params bit-equal"
    update = max(float((w.double() - p.double()).abs().max()) for w, p in zip(single["params"], p0))
    ctl = control()
    check(gap <= 1e-6 * update and gap <= 2 * ctl,
          f"{label}: mesh params {gap:.3g} from the single run's, above 1e-6 of its update "
          f"{update:.3g} or twice the 1-ulp control {ctl:.3g}")
    return f"params within {gap:.3g} = {gap / update:.3g} of the update (1-ulp control {ctl:.3g})"


def same_ledger(a, b) -> bool:
    return all(a[k] == b[k] for k in ("bits", "messages", "events", "history", "total_bits",
                                      "rounds"))


def mesh_path(torch, build):
    """Phase 3n: the federation mesh on 4 gloo ranks sharing the card."""
    from repro_torch.utils import tree_leaves

    # 3n-a: every driver, dense and QSGD(16), on the tiny task
    singles = {}
    tasks = {False: tiny_task(torch), True: tiny_task(torch, ragged=True)}
    for name, drv, fields, ragged in TINY_CASES:
        run, cls = driver(drv)
        build.reset_launches()
        singles[name] = dict(run_summary(torch, run(tasks[ragged], cls(**fields))),
                             launches=dict(build.LAUNCHES))
    ranks = spawn_mesh(torch, "tiny")
    for name, drv, fields, ragged in TINY_CASES:
        single = singles[name]
        for r, out in enumerate(ranks):
            got = out[name]
            check(got["executor"] == "chunk_fn", f"3n-a {name}: rank {r} ran {got['executor']}")
            check(same_ledger(got, single), f"3n-a {name}: rank {r}'s ledger differs")
            check(summary_gap(got, ranks[0][name]) == 0.0,
                  f"3n-a {name}: rank {r}'s params differ from rank 0's")
        run, cls = driver(drv)
        note = hold_mesh_gap(
            f"3n-a {name}", summary_gap(ranks[0][name], single), single,
            [a.detach().cpu() for a in tree_leaves(tasks[ragged].init_params())],
            lambda: summary_gap(run_summary(torch, run(tiny_task(torch, ragged, ulp=True),
                                                       cls(**fields))), single))
        packed = {k: sum(o[name]["launches"][k] for o in ranks)
                  for k in ("qsgd_quantize_pack", "qsgd_unpack_dequantize")}
        if "qsgd_levels" in fields and fields["qsgd_levels"]:
            want = {k: MESH_RANKS * v for k, v in single["launches"].items() if k in packed}
            check(packed == want, f"3n-a {name}: B1/B2 {packed} over the ranks, expected "
                                  f"{want} (each rank a launch per leaf per interaction)")
        print(f"phase 3n-a: {name} on mesh (2, 2) against one card: {note}, ledger equal, "
              f"acc {ranks[0][name]['test_acc']}; B1/B2 over the ranks {packed}")

    # 3n-c: seed lanes over the ranks, each lane its solo run
    run, cls = driver("fedavg")
    cfg = cls(rounds=3, local_steps=4, qsgd_levels=16, eval_every=1)
    for i, s in enumerate(SWEEP_SEEDS):
        solo = run_summary(torch, run(tasks[False], dataclasses.replace(cfg, seed=s)))
        for r, out in enumerate(ranks):
            lane = out["sweep"][i]
            check(summary_gap(lane, solo) == 0.0 and lane["test_acc"] == solo["test_acc"]
                  and lane["train_loss"] == solo["train_loss"] and same_ledger(lane, solo),
                  f"3n-c: rank {r}'s lane of seed {s} differs from its solo run")
    print(f"phase 3n-c: run_sweep(mesh=(2, 2)) of FedAvg QSGD(16), seeds {SWEEP_SEEDS}, one "
          f"lane a rank: every lane bit-equal to its solo run on every rank; B1 over the ranks "
          f"{sum(o['sweep_launches']['qsgd_quantize_pack'] for o in ranks)}")

    # 3n-b: the Appendix-A LeNet scale against single-card runs
    task = lenet_appendix_task(torch)
    singles = {}
    for name, drv, fields, shape, hops in lenet_mesh_cases():
        run, cls = driver(drv)
        arm = comparison_arm(torch, build, name, lambda: run(task, cls(**fields)),
                             fields["rounds"])
        control = run_summary(torch, run(lenet_appendix_task(torch, ulp=True), cls(**fields)))
        singles[name] = (arm, run_summary(torch, arm["res"]), control)
    p0 = [a.detach().cpu() for a in tree_leaves(task.init_params())]
    del task
    ranks = spawn_mesh(torch, "lenet")
    leaves = 10
    for name, drv, fields, shape, hops in lenet_mesh_cases():
        arm, single, control = singles[name]
        ctl = summary_gap(control, single)
        gap = summary_gap(ranks[0][name], single)
        for r, out in enumerate(ranks):
            got = out[name]
            check(same_ledger(got, single), f"3n-b {name}: rank {r}'s ledger differs")
            check(summary_gap(got, ranks[0][name]) == 0.0,
                  f"3n-b {name}: rank {r}'s params differ from rank 0's")
        note = hold_mesh_gap(f"3n-b {name}", gap, single, p0, lambda: ctl)
        packed = {k: sum(o[name]["launches"][k] for o in ranks)
                  for k in ("qsgd_quantize_pack", "qsgd_unpack_dequantize")}
        want = MESH_RANKS * fields["rounds"] * hops * leaves
        check(all(v == want for v in packed.values()),
              f"3n-b {name}: B1/B2 {packed} over the ranks, expected {want} = {MESH_RANKS} "
              f"ranks x {fields['rounds']} rounds x {hops} compressed hops x {leaves} leaves")
        PATH_LAUNCHES[f"3n-b {name} mesh {shape}"] = {
            k: sum(o[name]["launches"][k] for o in ranks) for k in ranks[0][name]["launches"]}
        print(f"phase 3n-b: LeNet-MNIST {name}, {fields['rounds']} rounds on mesh {shape} "
              f"against one card: {note}, mesh gap {gap:.3g} beside the single card's 1-ulp "
              f"control {ctl:.3g}, ledger equal; B1 = B2 = {want} = {MESH_RANKS} ranks x "
              f"{fields['rounds']} rounds x {hops} compressed hops x {leaves} leaves; "
              f"single card {arm['s_per_round']:.3f} s/round, peak {arm['peak_gb']:.2f} GB")
        print(f"  4 gloo ranks sharing one H100, not a scale-out figure: s/round "
              f"{[round(o[name]['s_per_round'], 3) for o in ranks]}, peak GB "
              f"{[round(o[name]['peak_gb'], 2) for o in ranks]} (evals included)")


# phase 3o: the model mesh.  qwen3-0.6b whole in bf16 with flash, and
# dbrx-132b's MoE FFN at full width, on 4 gloo ranks sharing the card
# (`launch.mesh.make_debug_mesh`, DTensors laid out by `launch.steps.place`),
# each step held against one card in relative L2.  A model-mesh run adds
# partial sums in another order (the row-parallel products, the gradient
# sum over "data"), so it is not bit-equal: it is held at MESH_BOUND x the
# gap of the one-card run from weights 1 bf16 ulp apart, and a control
# (one rank's wq shard zeroed; the chains not passed on) must exceed that.
MESH_LM_BATCH, MESH_SEQ, MESH_PREFILL, MESH_DECODE = 2, 512, 4, 16
MESH_BOUND = 2.0
FLASH_MESH = (MESH_PREFILL // 2, MESH_SEQ, MESH_SEQ, 8, 4, 128)  # a rank's prefill heads
MESH_MOE_BATCH = 2


def mesh_lm_cfg():
    import dataclasses

    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config(LM_ARCH), dtype="bfloat16", use_flash=True)


def mesh_lm_inputs(torch):
    import numpy as np

    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(0, 151936, (MESH_PREFILL, MESH_SEQ + MESH_DECODE + 1)))
    return toks.to("cuda")


def bf16_ulp(torch, tree):
    from repro_torch.utils import tree_map

    return tree_map(lambda t: torch.nextafter(t, torch.full_like(t, float("inf"))), tree)


def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def flat_full(torch, tree):
    """The tree's leaves whole, flattened in bf16 (every rank gathers; rank
    0 keeps them)."""
    import torch.distributed as dist

    from repro_torch.utils import tree_leaves

    leaves = [full(t).reshape(-1) for t in tree_leaves(tree)]
    if dist.is_initialized() and dist.get_rank():
        return None
    return torch.cat([t.to(torch.bfloat16) for t in leaves])


def rel_l2_bf16(a, b) -> float:
    """Relative L2 of two flat bf16 vectors, in f32 a chunk at a time."""
    num = den = 0.0
    for x, y in zip(a.split(1 << 26), b.split(1 << 26)):
        x, y = x.float(), y.float()
        num += float(((x - y) ** 2).sum())
        den += float((y ** 2).sum())
    return (num / den) ** 0.5


def mesh_lm_steps(torch, cfg, params, chain2, mesh):
    """The steps of phase 3o on `mesh` (None: one card), timed: a train
    round (C = 1, 2 x 512), a prefill (4 x 512) and 16 decode steps; with
    `chain2` on a pod mesh (or one card), a Fed-CHS and an HFL round over
    two chains of 1 x 512.  Returns flat results and the seconds of each."""
    import contextlib

    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.sharding.ctx import model_mesh
    from repro_torch.utils import tree_map

    toks = mesh_lm_inputs(torch)
    on = mesh is not None
    out, secs = {}, {}

    def clock(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return r

    with (model_mesh(mesh) if on else contextlib.nullcontext()), \
            (steps._replicating() if on else contextlib.nullcontext()):
        if not on or "pod" not in mesh.axis_names:
            b = {"tokens": toks[:MESH_LM_BATCH, :MESH_SEQ][None],
                 "labels": toks[:MESH_LM_BATCH, 1:MESH_SEQ + 1][None]}
            stacked = tree_map(lambda t: t[None], params)
            if on:
                stacked, b = steps.place(cfg, mesh, stacked, b, chains=1)
            new, loss = clock("train", lambda: steps.make_train_round(cfg)(stacked, b, 0.3))
            out["train"] = flat_full(torch, new)
            out["loss"] = float(full(loss))
            del new, stacked
            prompt = {"tokens": toks[:, :MESH_SEQ]}
            caches = tf.init_caches(cfg, MESH_PREFILL, MESH_SEQ + MESH_DECODE, device="cuda")
            pp, pr, cc = (params, prompt, caches) if not on else steps.place(
                cfg, mesh, params, prompt, caches)
            out["prefill"] = full(clock("prefill", lambda: steps.make_prefill_step(cfg)(pp, pr)
                                        )).float()
            logits = []

            def decode():
                nonlocal cc
                for i in range(MESH_DECODE):
                    tok = {"t": toks[:, MESH_SEQ + i:MESH_SEQ + i + 1]}
                    tok = (tok if not on else steps.place(cfg, mesh, batch=tok))["t"]
                    lg, cc = tf.decode_step(cfg, pp, cc, tok)
                    logits.append(full(lg).float())

            clock("decode", decode)
            out["decode"] = torch.stack(logits)
        if chain2 is not None and (not on or "pod" in mesh.axis_names):
            for variant in ("fedchs", "hfl"):
                b2 = {"tokens": toks[:2, :MESH_SEQ].reshape(2, 1, MESH_SEQ),
                      "labels": toks[:2, 1:MESH_SEQ + 1].reshape(2, 1, MESH_SEQ)}
                st2 = tree_map(lambda a, c: torch.stack([a, c]), params, chain2)
                if on:
                    st2, b2 = steps.place(cfg, mesh, st2, b2, chains=2)
                new, loss = clock(variant, lambda: steps.make_train_round(
                    cfg, variant=variant)(st2, b2, 0.3))
                out[variant] = flat_full(torch, new)
                del new, st2
    return out, secs


def mesh_moe_inputs(torch):
    from repro_torch.configs.registry import get_config
    from repro_torch.models import ffn as F

    cfg = get_config("dbrx-132b")
    gen = torch.Generator(device="cuda").manual_seed(5)
    p = F.init_moe(cfg, gen, torch.bfloat16)
    x = (torch.randn((MESH_MOE_BATCH, MESH_SEQ, cfg.d_model), generator=gen, device="cuda")
         * 0.5).to(torch.bfloat16)
    return cfg, p, x


def model_mesh_rank(rank: int) -> dict:
    """One rank of phase 3o, in its own process on the card: qwen3-0.6b on
    (2, 2) and on (pod 2, data 1, model 2), and the MoE FFN on
    (2, 2); rank 0 then runs the same steps on the card alone, their 1-ulp
    controls and the controls the bound must reject, and returns the gaps."""
    import dataclasses

    import torch

    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import ffn as F
    from repro_torch.models import transformer as tf
    from repro_torch.models.moe_shardmap import moe_routed_shardmap
    from repro_torch.sharding.specs import PartitionSpec as P
    from repro_torch.sharding.specs import distribute, named_shardings
    from repro_torch.utils import resolve_device

    torch.cuda.set_device(0)
    resolve_device("cuda")
    out = {}
    cfg = mesh_lm_cfg()
    params = tf.init_params(cfg, 0, "cuda")
    chain2 = tf.init_params(cfg, 1, "cuda")
    mesh22 = make_debug_mesh(2, 2)
    mesh_pod = make_debug_mesh(1, 2, pod=2)
    check(mesh22.size == mesh_pod.size == MESH_RANKS, f"rank {rank}: mesh sizes")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    got22, secs22 = mesh_lm_steps(torch, cfg, params, None, mesh22)
    out["launches22"] = dict(build.LAUNCHES)
    out["peak22_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # the control the bound must reject: one rank's wq shard zeroed
    from repro_torch.sharding.ctx import model_mesh

    wq0 = params["super"][0]["attn"]["wq"]
    p_z = dict(params, super=[dict(params["super"][0], attn=dict(params["super"][0]["attn"],
                                                                 wq=wq0.clone()))])
    with model_mesh(mesh22), steps._replicating():
        pp, pr = steps.place(cfg, mesh22, p_z, {"tokens": mesh_lm_inputs(torch)[:, :MESH_SEQ]})
        wq = pp["super"][0]["attn"]["wq"]
        if mesh22.axis_index("model") == 1:
            wq.to_local().zero_()
        zeroed = full(steps.make_prefill_step(cfg)(pp, pr)).float()
        del pp, pr, wq, p_z
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    got_pod, secs_pod = mesh_lm_steps(torch, cfg, params, chain2, mesh_pod)
    out["launches_pod"] = dict(build.LAUNCHES)
    out["peak_pod_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["secs"] = {**secs22, **secs_pod}
    if rank:
        del got22, got_pod, zeroed
    del chain2
    torch.cuda.empty_cache()

    mcfg, mp, mx = mesh_moe_inputs(torch)
    specs = {"router": P(), "w_gate": P("model"), "w_in": P("model"), "w_out": P("model")}
    dp = distribute(mp, named_shardings(mesh22, specs))
    dx = distribute(mx, named_shardings(mesh22, P("data")))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y_mesh, aux_mesh = moe_routed_shardmap(mcfg, dp, dx, mesh22)
    y_mesh = full(y_mesh)
    torch.cuda.synchronize()
    out["secs"]["moe"] = time.perf_counter() - t0
    del dp, dx
    if rank:
        del mp, mx, y_mesh, params
        torch.cuda.empty_cache()
        return out

    # rank 0: the same steps on the card alone, and the controls
    torch.cuda.empty_cache()
    chain2 = tf.init_params(cfg, 1, "cuda")
    ref, ref_secs = mesh_lm_steps(torch, cfg, params, chain2, None)
    ulp, _ = mesh_lm_steps(torch, cfg, bf16_ulp(torch, params), bf16_ulp(torch, chain2), None)
    del chain2
    out["ref_secs"] = ref_secs
    rows = {}
    for k in ("train", "prefill", "decode", "fedchs", "hfl"):
        got = got22[k] if k in got22 else got_pod[k]
        rows[k] = (rel_l2_bf16(got, ref[k]), rel_l2_bf16(ulp[k], ref[k]))
    rows["loss"] = (abs(got22["loss"] - ref["loss"]) / abs(ref["loss"]),
                    abs(ulp["loss"] - ref["loss"]) / abs(ref["loss"]))
    # the chains not passed on: each chain's leaves stay on their own pod
    from repro_torch.utils import tree_leaves

    sizes = [t.numel() for t in tree_leaves(params)]
    parts = ref["fedchs"].split([2 * n for n in sizes])
    unrolled = torch.cat([torch.cat([q.reshape(2, -1)[1], q.reshape(2, -1)[0]]) for q in parts])
    out["rejected"] = {
        "prefill, one rank's wq shard zeroed": rel_l2(zeroed, ref["prefill"]),
        "fedchs, chains not passed on": rel_l2_bf16(got_pod["fedchs"], unrolled)}
    out["lm"] = rows

    # the MoE FFN: the grouped oracle on one card, one batch row a group
    gcfg = dataclasses.replace(mcfg, moe_groups=2)
    y_ref, aux_ref = F.moe_forward(gcfg, mp, mx)
    y_ulp, _ = F.moe_forward(gcfg, mp, torch.nextafter(mx, torch.full_like(mx, float("inf"))))

    def flipped(a, b):  # rows (tokens) whose output moved past 1% of the row's norm
        a, b = a.float().reshape(-1, a.shape[-1]), b.float().reshape(-1, b.shape[-1])
        return int(((a - b).norm(dim=1) > 0.01 * b.norm(dim=1)).sum())

    out["moe"] = dict(gap=rel_l2(y_mesh.float(), y_ref.float()),
                      control=rel_l2(y_ulp.float(), y_ref.float()),
                      flips=flipped(y_mesh, y_ref), control_flips=flipped(y_ulp, y_ref),
                      aux=(float(full(aux_mesh)) * mcfg.router_aux_coef, float(aux_ref)))
    # and global expert choice against the 1-rank interior
    y_glob, _ = F.moe_forward(mcfg, mp, mx)
    y_one, _ = moe_routed_shardmap(mcfg, mp, mx, make_debug_mesh(1, 1))
    out["moe"]["one_rank_equal"] = bool(torch.equal(y_one, y_glob))
    return out


def roofline_check(torch):
    """Phase 3o-d: the dry run's terms (`launch.steps.lower_spec` on fake
    tensors at (1, 1), priced on H100) for qwen3-0.6b's prefill 4 x 512 and
    train round 2 x 512, beside the card's time and peak for the same steps."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.roofline import analyze_trace, roofline_terms
    from repro_torch.utils import tree_map

    cfg = mesh_lm_cfg()
    mesh = make_debug_mesh(1, 1, device="cpu")
    params = tf.init_params(cfg, 0, "cuda")
    toks = mesh_lm_inputs(torch)
    shapes = dict(steps.SHAPES)
    cases = {"prefill_32k": ("prefill", MESH_PREFILL), "train_4k": ("train", MESH_LM_BATCH)}
    for shape, (label, batch) in cases.items():
        steps.SHAPES = dict(shapes, **{shape: dict(shapes[shape], seq_len=MESH_SEQ,
                                                   global_batch=batch)})
        try:
            t0 = time.perf_counter()
            rec = analyze_trace(steps.lower_spec(steps.build_lowering(cfg, shape, mesh), mesh))
            t_dry = time.perf_counter() - t0
        finally:
            steps.SHAPES = shapes
        terms = roofline_terms(rec)
        if label == "prefill":
            fn = steps.make_prefill_step(cfg)
            args = (params, {"tokens": toks[:, :MESH_SEQ]})
        else:
            fn = steps.make_train_round(cfg)
            args = (tree_map(lambda t: t[None], params),
                    {"tokens": toks[None, :batch, :MESH_SEQ],
                     "labels": toks[None, :batch, 1:MESH_SEQ + 1]}, 0.3)
        fn(*args)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        r = fn(*args)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        del r
        pred_s = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
        print(f"phase 3o-d: {LM_ARCH} {label} ({batch} x {MESH_SEQ}, bf16, flash) at (1, 1): "
              f"dry run (H100, {t_dry:.1f} s on the host) compute {terms['compute_s'] * 1e3:.3f} "
              f"ms, memory {terms['memory_s'] * 1e3:.3f} ms, collective "
              f"{terms['collective_s'] * 1e3:.3f} ms, bound {terms['bound']}, peak "
              f"{rec['memory']['peak_bytes'] / 1e9:.2f} GB; card {card_s * 1e3:.1f} ms "
              f"({card_s / pred_s:.2f}x the dominant term), peak "
              f"{peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB above the "
              f"{base / 1e9:.2f} GB held before it)")
    del params


def model_mesh_path(torch, build):
    """Phase 3o: the model mesh on 4 gloo ranks sharing the card (one card:
    not a scale-out figure), then the dry run against the card."""
    from repro_torch.launch.mesh import spawn_ranks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = spawn_ranks(model_mesh_rank, MESH_RANKS)
    except RuntimeError as e:
        fail(f"phase 3o: a rank failed:\n{e}")
    r0 = ranks[0]
    print(f"  [3o: {MESH_RANKS} ranks in {time.perf_counter() - t0:.1f} s, process start "
          f"included]")
    cfg = mesh_lm_cfg()
    for k, (gap, control) in r0["lm"].items():
        where = "(pod 2, data 1, model 2)" if k in ("fedchs", "hfl") else "(2, 2)"
        print(f"phase 3o: {LM_ARCH} whole (bf16, flash) {k} on {where}: relative L2 gap "
              f"{gap:.3e} to one card, 1-ulp control {control:.3e} ({gap / control:.2f}x)")
        check(control > 0 and gap <= MESH_BOUND * control,
              f"3o {k}: gap {gap:.3e} over {MESH_BOUND} x the 1-ulp control {control:.3e}")
    worst = max(c for _, c in r0["lm"].values())
    for k, gap in r0["rejected"].items():
        print(f"phase 3o: control, {k}: {gap:.3e}")
        check(gap > MESH_BOUND * worst, f"3o: the control '{k}' ({gap:.3e}) is not rejected")
    sec = r0["secs"]
    print(f"phase 3o: rank 0 s: train round {sec['train']:.2f}, prefill {sec['prefill']:.2f}, "
          f"{MESH_DECODE} decode steps {sec['decode']:.2f}, Fed-CHS round {sec['fedchs']:.2f}, "
          f"HFL round {sec['hfl']:.2f} (first calls: DTensor's sharding propagation "
          f"included); one card: {', '.join(f'{k} {v:.2f}' for k, v in r0['ref_secs'].items())}")
    print(f"phase 3o: peak a rank: {max(r['peak22_gb'] for r in ranks):.2f} GB on (2, 2), "
          f"{max(r['peak_pod_gb'] for r in ranks):.2f} GB on (pod 2, 1, 2)")
    n_local = cfg.num_layers
    for label, key, want in (("(2, 2)", "launches22", 3 * n_local),
                             ("(pod 2, 1, 2)", "launches_pod", 4 * n_local)):
        per_rank = [r[key].get("flash_attention", 0) for r in ranks]
        print(f"phase 3o: flash_attention launches a rank on {label}: {per_rank}")
        check(all(n == want for n in per_rank),
              f"3o {label}: flash launched {per_rank} times a rank, expected {want}")
        PATH_LAUNCHES[f"3o {label}"] = {"flash_attention": sum(per_rank)}
    m = r0["moe"]
    print(f"phase 3o: dbrx-132b MoE FFN (d_model 6144, 16 experts, d_ff 10752, bf16), "
          f"{MESH_MOE_BATCH} x {MESH_SEQ} on (2, 2) in {sec['moe']:.2f} s: relative L2 "
          f"{m['gap']:.3e} to the grouped oracle on one card (1-ulp control of x "
          f"{m['control']:.3e}); tokens moved past 1% of their norm (boundary flips) "
          f"{m['flips']} of {MESH_MOE_BATCH * MESH_SEQ} (control {m['control_flips']}); aux "
          f"{m['aux'][0]:.6f} vs {m['aux'][1]:.6f}; 1 rank = global expert choice bit for bit: "
          f"{m['one_rank_equal']}")
    check(m["one_rank_equal"], "3o: the 1-rank MoE interior differs from global expert choice")
    check(m["gap"] <= MESH_BOUND * m["control"],
          f"3o MoE: gap {m['gap']:.3e} over {MESH_BOUND} x the 1-ulp control {m['control']:.3e}")
    torch.cuda.empty_cache()
    roofline_check(torch)


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


def flash_work(B, T, S, H, Hkv, hd, itemsize, window=None):
    """(bytes, operations) of causal flash attention: q, k, v read once and
    the output written once; 4 hd operations per unmasked (q, k) pair (two
    products of 2 hd each; a window keeps the last `window` keys), the
    softmax's exp and sums not counted."""
    pairs = sum(min(q + 1, S, window or S) for q in range(T))
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
    # dbrx-132b's prefill shape (phase 3k-a), bf16: a row of its own
    B, T, S, H, Hkv, hd = FLASH_DBRX
    q, k, v = flash_inputs(torch, gen, B, T, S, H, Hkv, hd, torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    dbrx = timed_row(
        torch, flush, "flash_attention", f"dbrx-132b prefill B={B} T=S={T} H={H} Hkv={Hkv} "
        f"hd={hd} torch.bfloat16", *flash_work(B, T, S, H, Hkv, hd, q.element_size()),
        lambda: fa.flash_attention(q, k, v, causal=True),
        lambda: fa.flash_attention_plain(q, k, v, causal=True),
        library=lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                       enable_gqa=True),
        ops_per_s=BF16_OPS_PER_S)
    print(f"phase 4: flash_attention at dbrx-132b's prefill shape: "
          f"{dbrx['ms'] / dbrx['library_ms']:.3f}x SDPA's bf16 time")
    # phase 3m's shapes, bf16; SDPA takes the window as a boolean mask
    for name, shape, window in (("recurrentgemma-9b past its window", FLASH_RG,
                                 FLASH_RG_WINDOW),
                                ("phi-3-vision-4.2b prefill", FLASH_VLM, None),
                                ("whisper-tiny prefill", FLASH_ENC, None),
                                ("qwen3-0.6b prefill, a rank's heads on (2, 2)", FLASH_MESH,
                                 None)):
        B, T, S, H, Hkv, hd = shape
        q, k, v = flash_inputs(torch, gen, B, T, S, H, Hkv, hd, torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        pos = torch.arange(T, device="cuda")
        mask = pos[None, :] <= pos[:, None]
        if window:
            mask &= pos[None, :] > pos[:, None] - window

        def sdpa(qt=qt, kt=kt, vt=vt, mask=mask):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

        r = timed_row(
            torch, flush, "flash_attention", f"{name} B={B} T=S={T} H={H} Hkv={Hkv} hd={hd} "
            f"window={window} torch.bfloat16",
            *flash_work(B, T, S, H, Hkv, hd, q.element_size(), window),
            lambda q=q, k=k, v=v, window=window: fa.flash_attention(q, k, v, causal=True,
                                                                    window=window),
            lambda q=q, k=k, v=v, window=window: fa.flash_attention_plain(
                q, k, v, causal=True, window=window),
            library=sdpa, ops_per_s=BF16_OPS_PER_S)
        print(f"phase 4: flash_attention at {name}: {r['ms'] / r['library_ms']:.3f}x SDPA's "
              f"bf16 time (masked)")
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
        if stores or loads or any(key in name for key in [*shown.values(),
                                                          *PTXAS_NOTED.values()]):
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
    elapsed("3h's LM arms")
    lean_cross_check(torch)
    elapsed("3h")
    torch.cuda.empty_cache()
    scanned_lm_path(torch, build)
    elapsed("3i-b")
    torch.cuda.empty_cache()
    telemetry_lm_path(torch, build)
    elapsed("3j-a's LM arm")
    torch.cuda.empty_cache()
    moe_serving_path(torch, build)
    torch.cuda.empty_cache()
    moe_train_step_path(torch, build)
    torch.cuda.empty_cache()
    moe_fed_path(torch, build)
    elapsed("3k")
    torch.cuda.empty_cache()
    mla_serving_path(torch, build)
    torch.cuda.empty_cache()
    mla_train_step_path(torch, build)
    torch.cuda.empty_cache()
    mla_fed_path(torch, build)
    elapsed("3l-a, 3l-b, 3l-c")
    torch.cuda.empty_cache()
    ssd_path(torch, build)
    elapsed("3l-d")
    torch.cuda.empty_cache()
    rglru_serving_path(torch, build)
    torch.cuda.empty_cache()
    rglru_window_path(torch, build)
    torch.cuda.empty_cache()
    rglru_fed_path(torch, build)
    elapsed("3m-a, 3m-b, 3m-c")
    torch.cuda.empty_cache()
    whisper_path(torch, build)
    torch.cuda.empty_cache()
    vlm_path(torch, build)
    elapsed("3m-d, 3m-e")
    torch.cuda.empty_cache()
    mesh_path(torch, build)
    elapsed("3n")
    torch.cuda.empty_cache()
    model_mesh_path(torch, build)
    elapsed("3o")
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
            "launches_on_paths": {path: counts.get(name, 0)
                                  for path, counts in PATH_LAUNCHES.items()},
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
