#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing one JSON line (every measurement carries the card's
name and power limit):

1. device — ``nvidia-smi`` name and power limit, ``torch.cuda`` name/count;
2. build — compile the kernels from ``paddle_tpu_torch/kernels/csrc`` with
   ``nvcc`` for ``sm_90a`` (one process per source, in parallel);
3. kernels — hold each CUDA kernel against its plain PyTorch version on the
   card at the Llama-2-7B serving shapes (kernel A also at a GQA geometry,
   HQ=32/HKV=8, over a mixed batch of decode rows, prompt-chunk rows and
   q_lens=0 rows; kernels A and 4 also at head dims 192 and 256, over rows
   that end in every rank of their cluster split, and timed over a
   decode-heavy batch and the GQA mixed batch: ``check_paged_split``; at
   head dims 320, 384, 448 and 512, O's columns split over two CTAs, and at
   576 and 1024 (the runtime-D instance, ceil(D / 256) CTAs), in bf16, fp16,
   fp32 and over the int8 pool, with the launch plan each took:
   ``check_paged_wide``) and the flash-attention kernels (forward, dq, dk/dv) at
   the train shape ``[2, 4096, 32, 128]`` causal, unmasked and with a
   document mask (each timed beside its bound, with its share of the
   bound and of the FlashMask tiles it visits, and beside SDPA: causal, or
   given the dense document mask), at GQA 32/8 with C=2 and C=4 FlashMask
   bounds and a ragged S, in fp16 and fp32 at GQA 32/8 and at head dims 64,
   192 and 256 in bf16 (the fp16, fp32 and D 256 cases timed beside SDPA
   given the dense band mask), the fp32 forward (``csrc/flash_fwd_tf32.cu``,
   3xTF32 on the tensor cores to head dim 256, its plan held to its Python
   mirror) also unmasked causal beside SDPA's ``is_causal``, at head dims 64,
   192 and 256 and at the ragged S, gated at most 1.0x SDPA's fp32 forward
   under the C=2 causal band, each case's error printed beside its limit,
   fp32 dq and dk/dv likewise (``csrc/flash_bwd_tf32.cu``, the same split,
   its plan held to its mirror: gated together at most 1.0x SDPA's fp32
   backward under the C=2 band, timed beside it causal and at D 256, two
   runs bitwise equal causal and under a document mask),
   and at head dims 320, 384, 448 and 512 and
   576 and 1024 (bf16 / fp16 on the tensor cores: the forward
   ``csrc/flash_fwd_wide.cu``, dq and dk/dv ``csrc/flash_bwd_wide.cu``,
   their launch plans held to their Python mirrors; fp32 on the CUDA-core
   instances and the runtime-D kernels) in bf16, fp16 and fp32, causal and
   under a document mask (the bf16 D 320, 512, 576 and 1024 cases timed
   beside SDPA, its backend named, the forward at most 1.0x SDPA's and dq
   + dk/dv at most 1.0x its whole backward at 320 and 512, dk/dv bitwise
   over two calls at 512; all three at D 1280, the forward's Q streamed
   beside K; 320 and 512 timed at S 4096 under a document mask:
   ``check_flash_wide``); kernel 16 (dk/dv) gated at most SDPA's whole
   backward causal, at most half its own causal time under the document
   mask, and bitwise equal over two runs; each flash kernel's cold-L2 time
   per call under the Llama step's document mask and at the GPT step's
   causal ``[4, 2048, 40, 128]``; the RMSNorm forward and backward and the rope forward and
   adjoint (kernels 7-10) at the train shapes (``[2, 4096, 4096]`` and
   ``[2, 4096, 32, 128]`` bf16) and at ragged bf16, fp32 and fp16 shapes
   (kernel 7's register and loop routes both), kernel 7 gated at most 1.0x
   ``F.rms_norm`` at the train shape and timed at 8 and 512 rows;
   kernels B and C in fp16 and fp32; the KV append under
   ``torch.cuda.set_sync_debug_mode("error")``; the residual LayerNorm and
   its adjoint (kernels 12 and 13) at GPT-3 13B's train shape ``[4, 2048,
   5120]`` and the residual RMSNorm's adjoint (kernel 11) at ``[2, 4096,
   4096]``, bf16, and all three at ragged rows in fp16 and fp32 (12 and 13
   also on each register shape of 13's plan), kernel 13 gated at least 50%
   of its bound and at most 1.0x the autograd ``F.layer_norm`` backward,
   its loop route timed beside it; the fused
   linear cross entropy forward, D recompute, dX and dW (kernels 17-19) at
   the train shape (x ``[8192, 4096]``, W ``[4096, 32000]`` bf16), at a
   ragged vocab, in the vocab-major layout, in fp16, at GPT-3 13B's tied
   head (W ``[50304, 5120]`` vocab-major, a 1152-column tail chunk) and in
   fp32, each case printing the route its forward and backward take
   (``flx_route``: the wgmma mainloop, mma.sync where
   TMA cannot address W's rows, in fp32 the 3xTF32 wgmma mainloop,
   ``csrc/flxent_tf32.cu``, where its split pass can read W in 16-byte
   vectors, else the CUDA cores; fp32 lse and tl held to a gate on the
   logits' own scale that one TF32 pass must fail) and holding two
   ``flxent_fwd`` and two ``flxent_bwd`` calls to the same bits, with the
   loss head's peak memory fused and unfused (fused must be lower, in bf16
   and in fp32), 17 gated at 1.0x the library's forward and 18 and 19 each
   at 1.25x the library's whole backward at the train shape, 18 and 19
   fp32 at 1.0x the library's fp32 backward at x ``[2048, 4096]`` (timed
   also at the fp32 train step's 8192 rows) and 17 fp32 at 1.0x its
   forward at both, then
   ``F.fused_linear_cross_entropy`` forward and backward in fp32; kernels 5
   and 6 at head dims 64 and 192 to 1024 (``check_decode_wide``), over
   batches whose lengths end on every rank boundary of their cluster split
   (``check_decode_split``), two calls bitwise equal, and timed beside SDPA
   at D 128 to 1024 in bf16 and over the int8 pool: at most 1.0x SDPA up to
   D 512 and kernel 5 at D 128 at least 35% of its bound (``decode_gate``);
   kernel 17's int8
   site on each of its routes (``flx_int8_route``), gated at 1.25x its
   library at the train shape; time kernel, plain
   version and, where one PyTorch call
   computes the same function, that call (device time per call from CUDA
   events with the L2 flushed before each call; back-to-back wall time per
   call, launch overhead included, as ``call_ms``);
4. serve — Llama-2-7B at full width (32 layers, seeded random bf16 weights)
   through ``ContinuousBatchingEngine`` (8 slots, block 16, chunk 64,
   max_model_len 2048) on 16 seeded requests (prompts of 64-512 tokens, 32
   new tokens each), with the launch counters reset just before and read
   just after: every request must finish with 32 tokens, each step must
   launch kernel A 32x, B 1x and C 64x, and the pool must drain;
   then a profile of three engine steps (device time by kernel category and
   the device's idle share);
5. logits — one mixed step's logits through the kernel path against the
   same model's forward through the plain versions, on the card, each
   measured against the plain versions run in fp32;
   then, on the same model: serve_unfused — the same requests through a
   second engine with ``FLAGS_use_fused_decode_layer=False`` (each step
   launches kernel 4 32x, RMSNorm kernel 7 65x, none of A, B, C; its
   logits through the same gate; token agreement with the fused engine
   reported); generate_paged — ``model.generate_paged`` on 8 prompts of 512
   tokens, 32 new tokens (the prefill launches flash_fwd 32x, rope_fwd 64x,
   rms_norm_fwd 65x; each of the 31 decode steps kernel 5 32x and
   rms_norm_fwd 65x; output ``[8, 544]``; every block freed; decode ms per
   step beside the ~4.0 ms it takes to read the weights; one decode step's
   logits through the relative gate); decode_fused — the public
   ``block_multihead_attention_fused`` at the 7B decode shape (kernel 6
   once, its output against the plain version, the pools bit for bit the
   plain append's); the kernel phase also holds kernels 4, 5, 6 at 7B
   (MHA and GQA 32/8) and A, 4, 5, 6 in fp16 and fp32 against their plain
   versions, and the decode and prefill appends under the sync check;
   then int8 serving on the same model: eval_loss_bf16 — ``model(ids,
   labels=labels)`` on 2 x 2048 tokens under ``no_grad``; serve_int8 —
   the serve phase's engine and requests with ``kv_cache_dtype="int8",
   weight_only_int8=True`` (the model quantized in place): each step
   launches A's int8 instance 32x, B 1x, C 64x and the weight-only int8
   matmul (kernel 20) 97x and nothing else, its logits through the gate
   against an fp32 run of the int8 plain path, ``bytes_per_token`` and
   the greedy agreement with the bf16 streams reported; serve_int8_unfused
   — the same with ``FLAGS_use_fused_decode_layer=False`` (kernel 4's int8
   instance 32x, RMSNorm 65x, kernel 20 97x); eval_loss_int8 — the
   quantized model's loss through kernel 17's int8 site (2 launches,
   kernel 20 96x) against the plain int8 head's; and the two decode
   entries over an int8 pool (kernels 5 and 6's int8 instances once each).
   The kernel phase holds kernel 20 at the step's three projection shapes
   (each at most 1.25x cuBLAS's bf16 ``x @ W`` in the same call), at eight
   rows, in fp32 (the mma.sync instance, two TF32 passes of split x: at
   most 1.0x ``torch.matmul`` in fp32 with TF32 off at gate/up), at fp16
   ragged rows, one row, 4096 rows, rows aligned to 2 and 1 bytes, and
   ``[77, 4100] x [4100, 32003]`` in bf16 (its mma.sync route, at most 1.0x
   cuBLAS's bf16 product), fp16 and fp32, A/4/5/6 over int8
   pools with q in bf16, fp16 and fp32, 17's int8 site on each route
   ``flx_int8_route`` names (kernel 20's wgmma mainloop at the loss head's
   shape, gated at 1.25x its library, and at 8-, 64-, 128- and 256-row
   tiles; mma.sync at V 32003, vocab-major and fp16 V 3001; in fp32 the
   2xTF32 wgmma mainloop, gated at 1.0x its fp32 library at x ``[2048,
   4096]``, its widen pass bitwise and gated at 1.0x PyTorch's one call for
   the same plane in both layouts, and the CUDA cores at V 3001), and the
   int8 appends under the sync check;
6. train — Llama-2-7B widths cut to 8 layers (bf16, recompute,
   ``AdamW(multi_precision=True)``, every JAX default) on 2 x 4096
   document-packed tokens with the FlashMask document mask, 1 warm-up and
   4 timed steps with the launch counters reset before each: every
   parameter gets a finite non-zero gradient, each step launches flash_fwd
   16x, flash_bwd_dq / flash_bwd_dkv 8x, rms_norm_fwd 33x, rms_norm_bwd
   17x, rope_fwd 32x, rope_bwd 16x, flxent_fwd 2x (partials and merge)
   and flxent_dchunk / flxent_dx / flxent_dw 8x (one per 4096-column vocab
   chunk) and nothing else, the loss falls; a profile of one step, whose
   flash kernel events must equal the step's flash launch counters; the step
   with ``FLAGS_use_fused_loss`` off and on, back to back (the profile
   reports each flash kernel's in-step ms per launch beside its cold-L2 ms
   per call); then a 2-layer
   S=1024 copy whose loss and gradients through the kernels must be no
   further from an fp32 run of the plain versions than the bf16 plain
   path; then fp16 — a 2-layer Llama-2-7B-width model with
   ``dtype="float16"`` trains one step (the same gates, flash 4/2/2) and a
   fresh one runs ``generate_paged`` on 2 x 512 prompts, 8 new tokens
   (launches, and the dense prefill's logits through kernel 14 in fp16
   against the fp16 plain path's distance from fp32); then train_fp32 — a
   2-layer Llama-2-7B-width model with ``dtype="float32"`` trains 3 steps
   (the same gates, flash 4/2/2 a step on the fp32 tensor-core kernels,
   the loss head on its 3xTF32 instance: flxent_fwd 9x (a partials
   launch per 4096-column sub-chunk, then the merge), flxent_split 26x (x
   and each sub-chunk of W, forward and backward) and flxent_dchunk / dx /
   dw 16x, one per 2048-column sub-chunk of the backward, step 1's
   loss and every gradient held to the plain fp32 path's, which the plain
   path in one TF32 pass must miss) and a profile of one more step (each
   flash kernel's in-step ms per launch, and the 3xTF32 loss-head kernels'
   events equal to their launches, with their in-step ms per launch);
   then 2-layer fp16 and
   fp32 models served through the engine with ``weight_only_int8=True``
   (kernel 20 7x a step on its wgmma and mma.sync instances; logits
   against the plain path's distance from an fp32 / fp64 reference) and
   their evaluation loss (17's int8 site on its wgmma instance twice, on
   its 2xTF32 instance in fp32 a partials launch per sub-chunk after each
   sub-chunk's widen launch, and the merge; within 1e-4 of the plain int8
   head's);
7. train_gpt — after the Llama model is freed, GPT-3 13B widths cut to 8
   layers (hidden 5120, 40 heads of dim 128, vocab 50304, biases, the lm
   head tied to the word embedding; bf16, every JAX default:
   ``FLAGS_use_fused_decode_layer`` and ``FLAGS_use_fused_loss`` on,
   ``AdamW(multi_precision=True)``) on 4 x 2048 next-token pairs, 1
   warm-up and 4 timed steps with the launch counters reset before each:
   every parameter gets a finite non-zero gradient, each step launches
   flash_fwd / flash_bwd_dq / flash_bwd_dkv 8x, ln_residual /
   ln_residual_bwd 8x (``ln_2``'s residual LayerNorm), flxent_fwd 2x and
   flxent_dchunk / dx / dw 13x (the vocab-major head's 4096-column chunks)
   and nothing else, the loss falls; tokens/s, MFU, peak memory, a
   profile of one step (flash events held to the counters, in-step ms per
   launch beside cold-L2 ms per call); then a
   2-layer S=1024 copy held to the fp32 plain path as for Llama;
8. residual_repair — the incubate ``fused_rms_norm_residual`` with inputs
   that need gradients: its outputs carry ``ResidualNormFunction``'s node,
   kernel C and kernel 11 each launch once between a reset and a read of
   the counters, and the x, residual and weight gradients match the plain
   versions';
9. wide_heads — head dims above 256 on the main paths: 2-layer
   Llama-2-7B-width models with 8 heads of 512 and of 320 (GQA 8/2)
   through the engine fused and unfused over bf16 and int8 KV pools,
   ``generate_paged`` and two document-masked train steps, each with the
   serve, decode and train phases' gates (launch counts, logits against the
   plain path, grad coverage, a falling loss; each train step launches
   the wide forward, dq and dk/dv, ``flash_fwd_wide`` 4x and
   ``flash_bwd_dq_wide`` / ``flash_bwd_dkv_wide`` 2x, and no other flash
   kernel).

Each profile line (the serve, train and GPT train steps') carries the norm
kernels' (B, C, 7-10, 12, 13) in-step ms per launch beside their cold-L2 ms
per call, and one ``norm_in_step_vs_cold`` line gathers them.

Then the kernel table as one JSON line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. The script exits non-zero at the first
failed check, without a CUDA card, and outside a checkout.
"""

from __future__ import annotations

import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
WEIGHT_BYTES_7B = 6_738_415_616 * 2  # Llama-2-7B's parameters in bf16: one decode step reads them all
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak (data sheet)
FP32_FLOP_PER_S = 67e12  # H100 SXM fp32 peak outside the tensor cores (data sheet)
TF32_FLOP_PER_S = 494.7e12  # H100 SXM dense TF32 tensor-core peak (data sheet): the fp32 split kernels' passes
BF16_REL = 2.0 ** -7  # one bf16 ulp relative to the value (8-bit significand)


T0 = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else f"nvidia-smi failed: {out.stdout.strip()}"


def call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean wall time of one ``fn()`` call issued back to back (CUDA events
    around the run, after a warm-up): device time plus whatever launch
    overhead the device waits on."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_events(prof):
    import torch

    # kernels and copies: not the device-side mirror of the schedule's ProfilerStep annotation (a user annotation)
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]


def traced(run) -> tuple:
    """``torch.profiler`` (CPU and CUDA activities) over ``run()`` alone:
    ``(prof, wall_us)``. The profiler first traces a warm-up stage, a short
    device spin and a sync, and discards it; only then does ``run()``
    start under the recording stage."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.cuda._sleep(HEAD_START_CYCLES)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    return prof, wall_us


L2_FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2
HEAD_START_CYCLES = 2_000_000  # ~1 ms of device spin at the H100's clock: the host enqueues the call meanwhile


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one ``fn()`` call with a cold L2, from CUDA
    events. Before each call the device spins for ~1 ms (the host enqueues
    the call meanwhile, so the device never waits on a launch) and then
    fills a 64 MB int8 buffer; a pair of events around ``fn()`` alone times
    it on the stream. Unlike a profiler trace, no record can go missing."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.int8, device="cuda")
    for i in range(warmup):
        flush.fill_(i + 1)
        fn()
    torch.cuda.synchronize()
    pairs = []
    for i in range(iters):
        torch.cuda._sleep(HEAD_START_CYCLES)
        flush.fill_(i % 100 + 1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bound(nbytes: float, flops: float, flop_per_s: float = BF16_FLOP_PER_S) -> dict:
    """The least time for moving ``nbytes`` and doing ``flops`` at the
    card's peak rates (``flop_per_s``: the rate of the operations' type)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def within(got, want, atol: float, rel: float):
    """(max abs error, ok): every element within ``atol + rel * max(|got|, |want|)``."""
    import torch

    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool((err <= atol + rel * torch.maximum(g.abs(), w.abs())).all())
    return float(err.max()), ok


# -- kernel A inputs -----------------------------------------------------------

def paged_batch(dev, gen, hq: int, hkv: int, d: int = 128, bs: int = 16, c: int = 64, mbs: int = 128,
                dtype=None, q_lens=(64, 64, 1, 1, 1, 40, 0, 1), lens=(0, 192, 511, 300, 63, 448, 200, 1000)):
    """A batch of chunk rows, by default the mixed one of 8 slots: two full
    prompt chunks, decode rows, a partial chunk and an idle slot (q_lens 0)
    with stale lens. Table entries past each slot's used blocks hold
    out-of-range garbage. bf16 unless ``dtype`` says otherwise."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaRotaryEmbedding

    q_lens = torch.tensor(q_lens, dtype=torch.int32)
    lens = torch.tensor(lens, dtype=torch.int32)
    b = q_lens.numel()
    used = [-(-(int(lens[i]) + int(q_lens[i])) // bs) if q_lens[i] else 0 for i in range(b)]
    nb = sum(used) + 8
    perm = torch.randperm(nb, generator=torch.Generator().manual_seed(1)).tolist()
    tables = torch.full((b, mbs), 1 << 30, dtype=torch.int32)
    at = 0
    for i in range(b):
        tables[i, : used[i]] = torch.tensor(perm[at: at + used[i]], dtype=torch.int32)
        at += used[i]
    bf = dtype or torch.bfloat16
    q = torch.randn((b, c, hq, d), generator=gen, device=dev).to(bf)
    kc = torch.randn((nb, hkv, bs, d), generator=gen, device=dev).to(bf)
    vc = torch.randn((nb, hkv, bs, d), generator=gen, device=dev).to(bf)
    rope = LlamaRotaryEmbedding(d, 4096, 10000.0, dev)
    cos, sin = (t.reshape(b, c, d) for t in rope(c, lens.to(dev)))
    return dict(q=q, cos=cos, sin=sin, key_cache=kc, value_cache=vc, block_tables=tables.to(dev),
                seq_lens=lens.to(dev), q_lens=q_lens.to(dev)), used


def paged_cost(args: dict, rope: bool = True) -> tuple:
    """Bytes the chunk attention must move and the flops its valid rows
    need, counted from this run's lengths: q rows below ``q_lens`` (and
    their rope rows if ``rope``), the K/V rows below ``lens + q_lens`` of
    each slot with a valid row, the table entries those rows sit in,
    ``lens`` and ``q_lens``, and the whole output."""
    q, kc = args["q"], args["key_cache"]
    b, c, hq, d = q.shape
    _, hkv, bs, _ = kc.shape
    lens, q_lens = args["seq_lens"].tolist(), args["q_lens"].tolist()
    ends = [n + m for n, m in zip(lens, q_lens) if m]
    rows = sum(q_lens)
    nbytes = (rows + b * c) * hq * d * q.element_size() + rope * 2 * rows * d * args["cos"].element_size()
    nbytes += sum(ends) * 2 * hkv * d * kc.element_size() + sum(-(-e // bs) for e in ends) * 4 + 2 * b * 4
    flops = sum(4 * d * hq * (lens[i] + j + 1) for i in range(b) for j in range(q_lens[i]))
    return nbytes, flops


def decode_cost(args: dict, rope: bool = True) -> tuple:
    """Bytes the decode attention must move and its flops, counted from this
    run's lengths (which include the current token): q of each slot with a
    length above 0 (and its rope rows if ``rope``), the K/V rows below
    ``lens``, the table entries those rows sit in, ``lens``, and the whole
    output."""
    q, kc = args["q"], args["key_cache"]
    b, hq, d = q.shape
    _, hkv, bs, _ = kc.shape
    lens = [n for n in args["seq_lens"].tolist() if n]
    rows = len(lens)
    nbytes = (rows + b) * hq * d * q.element_size() + rope * 2 * rows * d * args["cos"].element_size()
    nbytes += sum(lens) * 2 * hkv * d * kc.element_size() + sum(-(-n // bs) for n in lens) * 4 + b * 4
    return nbytes, sum(4 * d * hq * n for n in lens)


def decode_batch(dev, gen, hq: int, hkv: int, d: int = 128, bs: int = 16, mbs: int = 128, dtype=None):
    """The C = 1 form of :func:`paged_batch` for kernels 5 and 6: 8 slots,
    one query token each, lengths INCLUDING it — two of them exact multiples
    of the block size (512, 64) and an idle slot of length 0; table entries
    past each slot's used blocks hold out-of-range garbage. Rope rows are
    those of each slot's current position ``[8, 1, D]``. Returns the
    arguments and each slot's used blocks."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaRotaryEmbedding

    lens = torch.tensor([1, 193, 512, 301, 64, 449, 0, 1001], dtype=torch.int32)
    b = lens.numel()
    used = [-(-int(n) // bs) for n in lens]
    nb = sum(used) + 8
    perm = torch.randperm(nb, generator=torch.Generator().manual_seed(2)).tolist()
    tables = torch.full((b, mbs), 1 << 30, dtype=torch.int32)
    at = 0
    for i in range(b):
        tables[i, : used[i]] = torch.tensor(perm[at: at + used[i]], dtype=torch.int32)
        at += used[i]
    dt = dtype or torch.bfloat16
    q = torch.randn((b, hq, d), generator=gen, device=dev).to(dt)
    kc = torch.randn((nb, hkv, bs, d), generator=gen, device=dev).to(dt)
    vc = torch.randn((nb, hkv, bs, d), generator=gen, device=dev).to(dt)
    rope = LlamaRotaryEmbedding(d, 4096, 10000.0, dev)
    cos, sin = (t.reshape(b, 1, d) for t in rope(1, (lens - 1).clamp(min=0).to(dev)))
    return dict(q=q, cos=cos, sin=sin, key_cache=kc, value_cache=vc, block_tables=tables.to(dev),
                seq_lens=lens.to(dev)), used


def gathered_kv(args: dict, n_pos):
    """K and V of each slot's first ``n_pos`` positions gathered dense,
    ``[B, HKV, L, D]``, and L (the library yardstick's operands)."""
    kc, vc, tables = args["key_cache"], args["value_cache"], args["block_tables"]
    nb, hkv, bs, d = kc.shape
    b = tables.shape[0]
    n_blk = -(-max(n_pos) // bs)
    tab = tables[:, :n_blk].long().clamp(0, nb - 1)
    kd = kc[tab].permute(0, 2, 1, 3, 4).reshape(b, hkv, n_blk * bs, d)
    vd = vc[tab].permute(0, 2, 1, 3, 4).reshape(b, hkv, n_blk * bs, d)
    return kd, vd, n_blk * bs


PAGED_TOL = {"bfloat16": (1e-4, BF16_REL), "float16": (1e-4, 2.0 ** -10), "float32": (2e-5, 1e-5)}


def decode_heavy_batch(dev, gen, hq: int, hkv: int, d: int = 128, dtype=None):
    """8 decode rows (q_lens 1) over long histories at the serve engine's
    geometry (chunk width 64, block 16, max_model_len 2048: MBS 128): lens
    drawn from 1500-2047 with a fixed seed."""
    import torch

    lens = torch.randint(1500, 2048, (8,), generator=torch.Generator().manual_seed(3)).tolist()
    return paged_batch(dev, gen, hq, hkv, d=d, dtype=dtype, q_lens=(1,) * 8, lens=lens)[0]


SPLIT_SLOTS = ((128, 0), (1, 127), (1, 383), (29, 100))  # (q_lens, lens) of the split cases


def split_batches(dev, gen, hq: int, hkv: int, dtype=None):
    """One-slot batches (chunk width 128, block 16, MBS 128) whose rows end
    in every rank of kernels A / 4's split: one slot keeps the grid small
    enough that the card holds 8 ranks a cluster (rank r walks blocks [r *
    per, (r + 1) * per), per = ceil(blocks / 8)). A 128-row prompt from
    position 0 (per = 1, so row j's last position lies in rank j // 16 and
    the row is fully masked in every later rank), a decode row ending on
    the last position of rank 7 (lens 127), one on a 3-blocks-per-rank
    boundary (lens 383), and a chunk whose split leaves ranks 5-7 empty
    (lens 100, q_lens 29)."""
    return [paged_batch(dev, gen, hq, hkv, c=128, dtype=dtype, q_lens=(m,), lens=(n,))[0] for m, n in SPLIT_SLOTS]


def chunk_sdpa(args: dict, rope: bool = True):
    """Yardstick only (the port never calls it): SDPA over each slot's used
    positions gathered dense, with the chunk's causal mask, q roped
    beforehand when ``rope`` (kernel A) and taken as given otherwise
    (kernel 4); GQA through SDPA's ``enable_gqa``."""
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.kernels.paged_attention import rope_rows

    q, lens = args["q"], args["seq_lens"]
    b, c, hq, _ = q.shape
    hkv = args["key_cache"].shape[1]
    kd, vd, L = gathered_kv(args, [int(n) + int(m) for n, m in zip(lens, args["q_lens"])])
    pos = torch.arange(L, device=q.device)
    mask = (pos[None, None, :] < (lens[:, None] + torch.arange(c, device=q.device)[None] + 1)[:, :, None])[:, None]
    qt = (rope_rows(q, args["cos"][:, :, None], args["sin"][:, :, None]) if rope else q).transpose(1, 2)
    gqa = {"enable_gqa": True} if hq != hkv else {}
    return lambda: tF.scaled_dot_product_attention(qt, kd, vd, attn_mask=mask, **gqa)


def check_paged_split(dev, gen, card: dict) -> None:
    """Kernels A and 4 (bf16) against their plain versions where the
    history split across the cluster and the head dims of the redesign
    matter: head dims 192 and 256 at GQA 32/8 over the mixed batch;
    :func:`split_batches` at the 7B MHA geometry and GQA 32/8; the
    decode-heavy batch at the 7B geometry and the mixed batch at GQA 32/8,
    both timed (device ms, the bound of this run's lengths, SDPA over the
    gathered K/V in the same call). Rows past q_lens must be exact 0. Each
    line carries the cluster size the kernels ran with."""
    import torch
    from paddle_tpu_torch.kernels import paged_attention as kp

    atol, rel = PAGED_TOL["bfloat16"]
    cases = [(f"mixed_d{d}", paged_batch(dev, gen, 32, 8, d=d)[0], False) for d in (192, 256)]
    cases += [(f"split_{hq}_{hkv}_{m}_{n}", args, False) for hq, hkv in ((32, 32), (32, 8))
              for (m, n), args in zip(SPLIT_SLOTS, split_batches(dev, gen, hq, hkv))]
    cases += [("decode_heavy", decode_heavy_batch(dev, gen, 32, 32), True),
              ("mixed_gqa", paged_batch(dev, gen, 32, 8)[0], True)]
    for label, args, timed in cases:
        cargs = {k: v for k, v in args.items() if k not in ("cos", "sin")}
        runs = {"paged_chunk_fused": (lambda: kp.paged_flash_chunk_fused(**args),
                                      lambda: kp.paged_flash_chunk_fused_plain(**args), True),
                "paged_chunk": (lambda: kp.paged_flash_chunk(**cargs), lambda: kp.paged_flash_chunk_plain(**cargs),
                                False)}
        b, c, hq, d = args["q"].shape
        past = torch.arange(c, device=dev)[None, :] >= args["q_lens"][:, None]  # [B, C]: rows past q_lens
        line = {"phase": "kernel_check", "kernel": "paged A/4 (split)", "case": label, "hq": hq,
                "hkv": args["key_cache"].shape[1], "d": d, "chunk": c, "lens": args["seq_lens"].tolist(),
                "q_lens": args["q_lens"].tolist(), "cluster_size": kp.chunk_cluster_size(args["q"], args["key_cache"],
                                                                                         args["block_tables"]),
                "tolerance": f"{atol} + 2^-7*|x|"}
        for name, (run, run_plain, rope) in runs.items():
            got, want = run(), run_plain()
            torch.cuda.synchronize()
            err, ok = within(got, want, atol=atol, rel=rel)
            zero = bool((got[past] == 0).all())
            if not ok or not zero:
                fail(f"{name} disagrees with its plain version on {label} (max abs err {err}, rows past q_lens "
                     f"zero: {zero})")
            line[name] = {"max_abs_err": err}
            if timed:
                nbytes, flops = paged_cost(args, rope=rope)
                ms = device_ms(run)
                line[name].update(ms=ms, library_ms=device_ms(chunk_sdpa(args, rope)), bytes=nbytes, flops=flops,
                                  **bound(nbytes, flops))
                line[name]["share_of_bound"] = line[name]["bound_ms"] / ms
        emit({**line, "card": card})


def check_paged_wide(dev, gen, card: dict, records: dict) -> None:
    """Kernels A and 4 at head dims 320, 384, 448 and 512 (O's columns split
    over two CTAs: ``csrc/paged_chunk_wide.cu``) and 576, 1024 and 2048 (the
    runtime-D instance, ``csrc/paged_chunk_deep.cu``: ceil(D / 256) CTAs, q
    resident, tiles of 64 rows at 576, 32 at 1024, 16 at 2048) against their plain
    versions over :func:`paged_batch`'s mixed batch at GQA 8/2, in the
    storage :func:`wide_dtypes` names (bf16, fp16, fp32 and bf16 q over the
    int8 pool; at 1024 and 2048 bf16 and the int8 pool) (``PAGED_TOL`` by
    q's dtype; rows past q_lens exact 0), each with the launch plan it took
    (``chunk_plan`` on the CTAs the card holds at once: the column split,
    tile rows, ring slots, cluster size). Timed at 320, 512, 576 and 1024
    with bf16 q over the bf16 and the int8 pool (device ms, the bound of this
    run's lengths, the plain version, SDPA over the gathered K/V,
    dequantized for the int8 pool, and the backend it takes), and at 576 in
    fp16 and fp32 too; then the ``paged_deep_gate`` line
    (:func:`deep_gate`). D 2432 in fp32 runs the chunked walk (no 16 rows of
    fp32 q fit resident)."""
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.kernels import paged_attention as kp

    rows_ms = {}
    for d in (*WIDE_HEAD_DIMS, *DEEP_HEAD_DIMS, *DEEP_CHECKED):
        for dtype, int8 in wide_dtypes(d):
            name = str(dtype).split(".")[-1]
            atol, rel = PAGED_TOL[name]
            args, _ = paged_batch(dev, gen, 8, 2, d=d, dtype=dtype)
            if int8:
                args = int8_pool(args)
            cargs = {k: v for k, v in args.items() if k not in ("cos", "sin")}
            runs = {"paged_chunk_fused": (lambda: kp.paged_flash_chunk_fused(**args),
                                          lambda: kp.paged_flash_chunk_fused_plain(**args), True),
                    "paged_chunk": (lambda: kp.paged_flash_chunk(**cargs),
                                    lambda: kp.paged_flash_chunk_plain(**cargs), False)}
            _, c, hq, _ = args["q"].shape
            plan = kp._chunk_launch_plan(args["q"], args["key_cache"], args["block_tables"])
            past = torch.arange(c, device=dev)[None, :] >= args["q_lens"][:, None]
            line = {"phase": "kernel_check", "kernel": "paged A/4 wide", "d": d, "dtype": name,
                    "kv": "int8" if int8 else name, "hq": hq, "hkv": 2, "plan": plan,
                    "tolerance": f"{atol} + {rel}*|x|"}
            for kname, (run, run_plain, rope) in runs.items():
                got, want = run(), run_plain()
                torch.cuda.synchronize()
                err, ok = within(got, want, atol=atol, rel=rel)
                zero = bool((got[past] == 0).all())
                if not ok or not zero or got.dtype != dtype:
                    fail(f"{kname} at D {d} in {name}{' over the int8 pool' * int8} disagrees with its plain "
                         f"version (max abs err {err}, rows past q_lens zero: {zero}, dtype {got.dtype})")
                line[kname] = {"max_abs_err": err}
                if d in DEEP_HEAD_DIMS or (dtype == torch.bfloat16 and d in WIDE_TIMED):
                    nbytes, flops = paged_cost(args, rope=rope)
                    ends = [int(n) + int(m) for n, m in zip(args["seq_lens"], args["q_lens"])]
                    if int8:  # the scale planes, and the library on the pool dequantized to bf16
                        nbytes += 2 * 2 * 4 * sum(e for e, m in zip(ends, args["q_lens"].tolist()) if m)
                        kd, vd, n_pos = dequant_gathered(args, ends)
                    else:
                        kd, vd, n_pos = gathered_kv(args, ends)
                    pos = torch.arange(n_pos, device=dev)
                    cmask = (pos[None, None, :] < (args["seq_lens"][:, None]
                                                   + torch.arange(c, device=dev)[None] + 1)[:, :, None])[:, None]
                    qq = (kp.rope_rows(args["q"], args["cos"][:, :, None], args["sin"][:, :, None]) if rope
                          else args["q"]).transpose(1, 2)
                    source = "paged_chunk_deep.cu" if d in DEEP_HEAD_DIMS else "paged_chunk_wide.cu"
                    other = "" if dtype == torch.bfloat16 else f"_{name}"  # fp16 / fp32 q and pool (deep only)
                    rate = FP32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S  # fp32: CUDA cores
                    records[f"{kname}{'_int8' * int8}{other}_d{d}"] = r = dict(
                        source=f"paddle_tpu_torch/kernels/csrc/{source}", max_abs_err=err,
                        ms=device_ms(run), plain_ms=device_ms(run_plain, iters=5),
                        library_ms=device_ms(lambda: tF.scaled_dot_product_attention(qq, kd, vd, attn_mask=cmask,
                                                                                     enable_gqa=True)),
                        sdpa_backend=sdpa_backend(qq, kd, vd, cmask),
                        bytes=nbytes, flops=flops, **bound(nbytes, flops, rate))
                    r["share_of_bound"] = r["bound_ms"] / r["ms"]
                    line[kname] = r
                    del kd, vd, qq, cmask
                    if d == DEEP_HEAD_DIMS[-1] and dtype == torch.bfloat16:
                        rows_ms[f"{kname}{'_int8' * int8}_d{d}"] = deep_rows_ms(args, rope, atol, rel)
            emit({**line, "card": card})
    deep_gate(records, rows_ms, card)


PAGED_DEEP_GATE = 1.0  # A and 4 above head dim 512 at most this times SDPA over the gathered K/V, in the same call
DEEP_ROWS = (64, 32)  # the tile rows timed against each other at D 1024 (32: the plan's, two CTAs an SM)


def deep_rows_ms(args: dict, rope: bool, atol: float, rel: float) -> dict:
    """Kernel A (``rope``) or 4 at :data:`DEEP_ROWS` tile rows on one batch,
    in turns (64, 32, 32, 64: device ms, the two readings of each averaged),
    each held to the plain version first; returns the ms by rows and the
    rows the plan takes."""
    import torch
    from paddle_tpu_torch.kernels import paged_attention as kp

    call = {k: v for k, v in args.items() if rope or k not in ("cos", "sin")}
    cos, sin = (call.pop("cos"), call.pop("sin")) if rope else (None, None)
    what = "paged_flash_chunk_fused" if rope else "paged_flash_chunk"
    planes = (call.pop("k_scale", None), call.pop("v_scale", None))
    want = kp.paged_flash_chunk_fused_plain(**args) if rope else kp.paged_flash_chunk_plain(**call, k_scale=planes[0],
                                                                                          v_scale=planes[1])
    runs = {}
    for rows in DEEP_ROWS:
        def run(rows=rows):
            return kp._chunk_launch(what, call["q"], cos, sin, call["key_cache"], call["value_cache"],
                                    call["block_tables"], call["seq_lens"], call["q_lens"], None, *planes, rows=rows)
        got = run()
        torch.cuda.synchronize()
        err, ok = within(got, want, atol=atol, rel=rel)
        if not ok:
            fail(f"{what} at {rows} tile rows disagrees with its plain version (max abs err {err})")
        runs[rows] = run
    times = {rows: [] for rows in DEEP_ROWS}
    for rows in (*DEEP_ROWS, *reversed(DEEP_ROWS)):
        times[rows].append(device_ms(runs[rows]))
    plan = kp._chunk_launch_plan(call["q"], call["key_cache"], call["block_tables"], rope=rope)
    return {"ms_by_rows": {r: sum(t) / len(t) for r, t in times.items()}, "plan_rows": plan["rows"]}


def deep_gate(records: dict, rows_ms: dict, card: dict) -> None:
    """The ``paged_deep_gate`` line: A and 4 at :data:`DEEP_HEAD_DIMS` with
    bf16 q over the bf16 and the int8 pool, each at most
    :data:`PAGED_DEEP_GATE` times SDPA over the gathered K/V in the same
    call (device ms, bound, share of the bound, plain ms, SDPA's backend),
    the fp16 and fp32 readings at 576 beside them (not gated), and the tile
    rows timed against each other at D 1024."""
    cases, over = {}, []
    ungated = {k: {f: r[f] for f in ("ms", "bound_ms", "share_of_bound", "plain_ms", "library_ms", "sdpa_backend")}
               for k, r in records.items() if k.endswith(f"_d{DEEP_HEAD_DIMS[0]}") and "float" in k}
    for d in DEEP_HEAD_DIMS:
        for kname in ("paged_chunk_fused", "paged_chunk"):
            for sfx in ("", "_int8"):
                key = f"{kname}{sfx}_d{d}"
                r = records[key]
                cases[key] = {k: r[k] for k in ("ms", "bound_ms", "share_of_bound", "plain_ms", "library_ms",
                                                "sdpa_backend")}
                cases[key]["vs_sdpa"] = r["ms"] / r["library_ms"]
                if cases[key]["vs_sdpa"] > PAGED_DEEP_GATE:
                    over.append(key)
    emit({"phase": "paged_deep_gate", "gate": f"ms <= {PAGED_DEEP_GATE} x SDPA", "cases": cases,
          "not_gated": ungated, "rows_ms_d1024": rows_ms, "card": card})
    if over:
        fail(f"kernels A / 4 above head dim 512 slower than {PAGED_DEEP_GATE}x SDPA: {over}")


def check_chunk_plan(card: dict) -> None:
    """Kernels A and 4's launch geometry (``ptt_paged_chunk_plan``: split,
    columns, tile rows, ring slots, shared-memory bytes, walk) equals its
    Python mirror ``chunk_geometry`` for q in bf16, fp16 and fp32 over a
    pool of q's type and the int8 pool, at every multiple of 64 from 64 to
    2048 and at head dims past the resident walk's reach (2432-5376: 16
    rows, the chunked walk)."""
    import ctypes
    import torch
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels import paged_attention as kp

    fn = build.kernel_fn("ptt_paged_chunk_plan", [ctypes.c_int] * 3 + [ctypes.c_void_p])
    wrong = {}
    for io, dtype in ((1, torch.bfloat16), (2, torch.float16), (0, torch.float32)):
        for quant in (0, 1):
            for d in (*range(64, 2049, 64), 2432, 2624, 2688, 5312, 5376):
                buf = (ctypes.c_int * 6)()
                build.check(fn(io, quant, d, buf), "ptt_paged_chunk_plan")
                g = kp.chunk_geometry(d, dtype, bool(quant))
                want = [g["split"], g["columns"], g["rows"], g["slots"], g["smem"], int(g["walk"] == "resident")]
                if list(buf) != want:
                    wrong[f"{dtype} quant {quant} D {d}"] = {"kernel": list(buf), "python": want}
    emit({"phase": "paged_chunk_plan_check", "d": [64, 5376], "ok": not wrong, "wrong": wrong,
          **{f"d{d}": {str(t).split(".")[-1]: kp.chunk_geometry(d, t) for t in (torch.bfloat16, torch.float32)}
             for d in (576, 1024, 2048)}, "card": card})
    if wrong:
        fail(f"kernels A / 4's plans disagree with the kernel's geometry: {wrong}")


def check_paged_new(dev, gen, card: dict, records: dict) -> None:
    """Kernels 4, 5 and 6 against their plain versions at the 7B serving
    geometry (HQ = HKV = 32, D = 128, BS = 16) and GQA 32/8: kernel 4 over
    :func:`paged_batch`'s mixed batch, 5 and 6 over :func:`decode_batch`;
    timed at the 7B geometry, with SDPA over the gathered K/V as the library
    yardstick."""
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.kernels import paged_attention as kp

    atol, rel = PAGED_TOL["bfloat16"]
    tol = f"{atol} + 2^-7*|x|"
    for hq, hkv in ((32, 32), (32, 8)):
        args, _ = paged_batch(dev, gen, hq, hkv)
        cargs = {k: args[k] for k in ("q", "key_cache", "value_cache", "block_tables", "seq_lens", "q_lens")}
        got, want = kp.paged_flash_chunk(**cargs), kp.paged_flash_chunk_plain(**cargs)
        dargs, _ = decode_batch(dev, gen, hq, hkv)
        pargs = {k: dargs[k] for k in ("q", "key_cache", "value_cache", "block_tables", "seq_lens")}
        dgot, dwant = kp.paged_flash_decode(**pargs), kp.paged_flash_decode_plain(**pargs)
        fgot, fwant = kp.paged_flash_decode_fused(**dargs), kp.paged_flash_decode_fused_plain(**dargs)
        torch.cuda.synchronize()
        for name, g, w, zero in (("paged_chunk", got, want, bool((got[6] == 0).all()) and bool((got[2, 1:] == 0).all())),
                                 ("paged_decode", dgot, dwant, bool((dgot[6] == 0).all())),
                                 ("paged_decode_fused", fgot, fwant, bool((fgot[6] == 0).all()))):
            err, ok = within(g, w, atol=atol, rel=rel)
            if not ok or not zero:
                fail(f"{name} disagrees with its plain version at HQ={hq} HKV={hkv} "
                     f"(max abs err {err}, idle rows zero: {zero})")
            if hq != hkv:
                emit({"phase": "kernel_check", "kernel": name, "hq": hq, "hkv": hkv, "max_abs_err": err,
                      "tolerance": tol, "card": card})
                continue
            records[name] = {"max_abs_err": err}
        if hq != hkv:
            continue
        # yardsticks only (the port never calls them): SDPA over the dense gathered K/V
        kd1, vd1, L1 = gathered_kv(dargs, [int(n) for n in dargs["seq_lens"]])
        dmask = (torch.arange(L1, device=dev)[None, :] < dargs["seq_lens"][:, None])[:, None, None]
        qd = dargs["q"][:, :, None]
        qdr = kp.rope_rows(dargs["q"], dargs["cos"], dargs["sin"])[:, :, None]
        cases = {
            "paged_chunk": (lambda: kp.paged_flash_chunk(**cargs), lambda: kp.paged_flash_chunk_plain(**cargs),
                            chunk_sdpa(args, rope=False), paged_cost(args, rope=False)),
            "paged_decode": (lambda: kp.paged_flash_decode(**pargs), lambda: kp.paged_flash_decode_plain(**pargs),
                             lambda: tF.scaled_dot_product_attention(qd, kd1, vd1, attn_mask=dmask),
                             decode_cost(dargs, rope=False)),
            "paged_decode_fused": (lambda: kp.paged_flash_decode_fused(**dargs),
                                   lambda: kp.paged_flash_decode_fused_plain(**dargs),
                                   lambda: tF.scaled_dot_product_attention(qdr, kd1, vd1, attn_mask=dmask),
                                   decode_cost(dargs)),
        }
        for name, (run, run_plain, run_lib, (nbytes, flops)) in cases.items():
            source = "paged_chunk_fused.cu" if name == "paged_chunk" else "paged_decode.cu"
            records[name].update(
                source=f"paddle_tpu_torch/kernels/csrc/{source}", ms=device_ms(run),
                plain_ms=device_ms(run_plain, iters=5), library_ms=device_ms(run_lib),
                call_ms=call_ms(run), plain_call_ms=call_ms(run_plain, iters=5), **bound(nbytes, flops))
            emit({"phase": "kernel_check", "kernel": name, "hq": hq, "hkv": hkv, "tolerance": tol,
                  "bytes": nbytes, "flops": flops, **records[name], "card": card})


def check_paged_dtypes(dev, gen, card: dict) -> None:
    """Kernels A, 4, 5 and 6 in fp16 and fp32 at GQA 32/8 against their
    plain versions (the same fp32 math summed in another order: within one
    ulp of the type, plus a small absolute term for values near 0)."""
    import torch
    from paddle_tpu_torch.kernels import paged_attention as kp

    for dtype in (torch.float16, torch.float32):
        name = str(dtype).split(".")[-1]
        atol, rel = PAGED_TOL[name]
        args, _ = paged_batch(dev, gen, 32, 8, dtype=dtype)
        cargs = {k: args[k] for k in ("q", "key_cache", "value_cache", "block_tables", "seq_lens", "q_lens")}
        dargs, _ = decode_batch(dev, gen, 32, 8, dtype=dtype)
        pargs = {k: dargs[k] for k in ("q", "key_cache", "value_cache", "block_tables", "seq_lens")}
        pairs = {
            "paged_chunk_fused": (kp.paged_flash_chunk_fused(**args), kp.paged_flash_chunk_fused_plain(**args)),
            "paged_chunk": (kp.paged_flash_chunk(**cargs), kp.paged_flash_chunk_plain(**cargs)),
            "paged_decode": (kp.paged_flash_decode(**pargs), kp.paged_flash_decode_plain(**pargs)),
            "paged_decode_fused": (kp.paged_flash_decode_fused(**dargs), kp.paged_flash_decode_fused_plain(**dargs)),
        }
        torch.cuda.synchronize()
        errs = {}
        for k, (g, w) in pairs.items():
            errs[k], ok = within(g, w, atol=atol, rel=rel)
            if not ok or g.dtype != dtype:
                fail(f"{k} in {name} disagrees with its plain version (max abs err {errs[k]}, dtype {g.dtype})")
        emit({"phase": "kernel_check", "kernel": "paged A/4/5/6", "dtype": name, "hq": 32, "hkv": 8,
              "max_abs_err": errs, "tolerance": f"{atol} + {rel}*|x|", "card": card})


DECODE_WIDE = ((16, 16), (32, 8))  # (HQ, HKV) of the D 64, 192-1024 cases: MHA (Gemma-7B's 16 x 256) and GQA


def wide_dtypes(d: int) -> tuple:
    """The (q dtype, int8 pool) cases a wide check runs at head dim ``d``:
    bf16, fp16 and fp32 storage and bf16 q over the int8 pool, at 1024 and
    2048 bf16 and the int8 pool only, and at 2432 fp32 only."""
    import torch

    if d == DEEP_CHECKED[-1]:
        return ((torch.float32, False),)
    if d in (DEEP_HEAD_DIMS[-1], *DEEP_CHECKED):
        return ((torch.bfloat16, False), (torch.bfloat16, True))
    return ((torch.bfloat16, False), (torch.float16, False), (torch.float32, False), (torch.bfloat16, True))


def decode_pairs(dargs: dict) -> dict:
    """Kernels 5 and 6 and their plain versions on one batch, as thunks."""
    from paddle_tpu_torch.kernels import paged_attention as kp

    pargs = {k: v for k, v in dargs.items() if k not in ("cos", "sin")}
    return {"paged_decode": (lambda: kp.paged_flash_decode(**pargs), lambda: kp.paged_flash_decode_plain(**pargs)),
            "paged_decode_fused": (lambda: kp.paged_flash_decode_fused(**dargs),
                                   lambda: kp.paged_flash_decode_fused_plain(**dargs))}


def decode_agree(dargs: dict, what: str, idle: list) -> dict:
    """Kernels 5 and 6 on ``dargs`` against their plain versions
    (``PAGED_TOL`` by q's dtype), the slots in ``idle`` (length 0) exactly 0,
    and two calls bitwise equal; fails on a miss. Returns the max abs
    errors."""
    import torch

    dtype = dargs["q"].dtype
    atol, rel = PAGED_TOL[str(dtype).split(".")[-1]]
    errs = {}
    for k, (run, run_plain) in decode_pairs(dargs).items():
        g, g2, w = run(), run(), run_plain()
        torch.cuda.synchronize()
        errs[k], ok = within(g, w, atol=atol, rel=rel)
        zero = all(bool((g[i] == 0).all()) for i in idle)
        same = bool(torch.equal(g, g2))
        if not ok or not zero or not same or g.dtype != dtype:
            fail(f"{k} {what} disagrees with its plain version (max abs err {errs[k]}, idle slots zero {zero}, "
                 f"two calls bitwise equal {same}, dtype {g.dtype})")
    return errs


def check_decode_wide(dev, gen, card: dict) -> None:
    """Kernels 5 and 6 at head dims 64, 192 to 512 and 576 / 1024 (above
    the template instances of the other kernels: the same runtime-D
    kernel, O's columns over ceil(D / 512) CTAs) against their plain
    versions over :func:`decode_batch`, MHA 16/16 and GQA 32/8, in the
    storage :func:`wide_dtypes` names (both sides of the int8 pool
    dequantize to the same fp32 values); tolerance the bf16 pools' by q's
    dtype (:data:`PAGED_TOL`); the idle slot exactly 0, two calls bitwise
    equal. Each line names the launch plan (``decode_plan``)."""
    from paddle_tpu_torch.kernels import paged_attention as kp

    for d in (64, 192, 256, *WIDE_HEAD_DIMS, *DEEP_HEAD_DIMS):
        for hq, hkv in DECODE_WIDE:
            for dtype, int8 in wide_dtypes(d):
                name = str(dtype).split(".")[-1]
                dargs, _ = decode_batch(dev, gen, hq, hkv, d=d, dtype=dtype)
                if int8:
                    dargs = int8_pool(dargs)
                errs = decode_agree(dargs, f"at D {d} in {name}{' over the int8 pool' * int8} at HQ={hq} HKV={hkv}",
                                    [6])
                plan = kp._decode_launch_plan(dargs["q"], dargs["key_cache"], dargs["block_tables"], False)
                emit({"phase": "kernel_check", "kernel": "paged 5/6 wide", "d": d, "hq": hq, "hkv": hkv,
                      "dtype": name, "kv": "int8" if int8 else name, "max_abs_err": errs, "plan": plan,
                      "tolerance": "{} + {}*|x|".format(*PAGED_TOL[name]), "card": card})


def decode_split_batch(dev, gen, hq: int, hkv: int, d: int, dtype, int8: bool = False, bs: int = 16,
                       mbs: int = 128) -> tuple:
    """A decode batch whose lengths end on every rank's boundary of kernels
    5 / 6's cluster split at these shapes on this card (the plan's ``ranks``
    R for this pool, from the shapes only: 14 slots whatever the lengths,
    the pool quantized with ``int8``): slot 0 idle
    (length 0, must be exact 0), slot 1 of length 1, slot 2 of R - 1 blocks
    less 5 positions (fewer blocks than ranks: the last ranks walk nothing),
    slots 3 .. 3 + R - 1 of r + 1 whole blocks (one block a rank: each ends
    on rank r's last position), a slot of 3 R blocks (3 a rank, ending on
    the last rank's) and one of 3 R blocks less 7 positions (ragged); table
    entries past each slot's used blocks hold out-of-range garbage. Returns
    the arguments and R."""
    import torch
    from paddle_tpu_torch.kernels import paged_attention as kp
    from paddle_tpu_torch.models.llama import LlamaRotaryEmbedding

    b = 14
    q = torch.randn((b, hq, d), generator=gen, device=dev).to(dtype)
    probe = torch.empty((1, hkv, bs, d), dtype=torch.int8 if int8 else dtype, device=dev)
    ranks = kp._decode_launch_plan(q, probe, torch.empty((b, mbs), dtype=torch.int32, device=dev), False)["ranks"]
    lens = [0, 1, max(1, (ranks - 1) * bs - 5)] + [(r + 1) * bs for r in range(ranks)] + [3 * ranks * bs,
                                                                                          3 * ranks * bs - 7]
    lens = (lens + [bs + 3] * b)[:b]
    used = [-(-n // bs) for n in lens]
    nb = sum(used) + 8
    perm = torch.randperm(nb, generator=torch.Generator().manual_seed(4)).tolist()
    tables = torch.full((b, mbs), 1 << 30, dtype=torch.int32)
    at = 0
    for i in range(b):
        tables[i, : used[i]] = torch.tensor(perm[at: at + used[i]], dtype=torch.int32)
        at += used[i]
    kc = torch.randn((nb, hkv, bs, d), generator=gen, device=dev).to(dtype)
    vc = torch.randn((nb, hkv, bs, d), generator=gen, device=dev).to(dtype)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    rope = LlamaRotaryEmbedding(d, 4096, 10000.0, dev)
    cos, sin = (t.reshape(b, 1, d) for t in rope(1, (lens_t - 1).clamp(min=0).to(dev)))
    args = dict(q=q, cos=cos, sin=sin, key_cache=kc, value_cache=vc, block_tables=tables.to(dev),
                seq_lens=lens_t.to(dev))
    return (int8_pool(args) if int8 else args), ranks


def check_decode_split(dev, gen, card: dict) -> None:
    """Kernels 5 and 6 against their plain versions over
    :func:`decode_split_batch` (lengths on every rank boundary, 1, fewer
    blocks than ranks, an idle slot that must be exact 0, garbage table
    tails) at head dims 64 to 1024, MHA 8/8 and GQA 32/8, bf16 and bf16 q
    over the int8 pool, and fp16 / fp32 at 128 and 576; two calls bitwise
    equal. Each line carries the cluster size the kernels ran with."""
    import torch

    for d in (64, 128, 256, 320, 512, *DEEP_HEAD_DIMS):
        for hq, hkv in ((8, 8), (32, 8)):
            cases = [(torch.bfloat16, False), (torch.bfloat16, True)]
            if d in (128, DEEP_HEAD_DIMS[0]):
                cases += [(torch.float16, False), (torch.float32, False)]
            for dtype, int8 in cases:
                name = str(dtype).split(".")[-1]
                dargs, ranks = decode_split_batch(dev, gen, hq, hkv, d, dtype, int8)
                errs = decode_agree(dargs, f"over the split batch at D {d} in {name}{' over the int8 pool' * int8} "
                                           f"at HQ={hq} HKV={hkv} (ranks {ranks})", [0])
                emit({"phase": "kernel_check", "kernel": "paged 5/6 split", "d": d, "hq": hq, "hkv": hkv,
                      "dtype": name, "kv": "int8" if int8 else name, "cluster_size": ranks,
                      "lens": dargs["seq_lens"].tolist(), "max_abs_err": errs,
                      "tolerance": "{} + {}*|x|".format(*PAGED_TOL[name]), "card": card})


DECODE_GATE = 1.0  # kernels 5 and 6 at most this times SDPA over the gathered K/V, decode batch, D 128-512
DECODE_SHARE_GATE = 0.35  # kernel 5 at D 128 bf16 (MHA 32/32) at least this share of its bound
DECODE_TIMED = ((128, 32, 32), (256, 16, 16), (320, 16, 16), (512, 16, 16), (576, 16, 16), (1024, 16, 16))
STEP_LENS = (544,) * 8  # the generate_paged phase's decode step: 8 prompts of 512 tokens, 32 new (its middle)


def step_batch(dev, gen, bs: int = 16, mbs: int = 128) -> dict:
    """:func:`decode_batch` at the 7B geometry with every slot at the
    ``generate_paged`` step's length (:data:`STEP_LENS`: uniform, where the
    decode batch is skewed), each slot's blocks distinct; table entries
    past them hold out-of-range garbage."""
    import torch

    args, _ = decode_batch(dev, gen, 32, 32)
    b, used = len(STEP_LENS), [-(-n // bs) for n in STEP_LENS]
    nb = sum(used)
    perm = torch.randperm(nb, generator=torch.Generator().manual_seed(5)).tolist()
    tables = torch.full((b, mbs), 1 << 30, dtype=torch.int32)
    at = 0
    for i in range(b):
        tables[i, : used[i]] = torch.tensor(perm[at: at + used[i]], dtype=torch.int32)
        at += used[i]
    return {**args, "key_cache": torch.randn((nb, 32, bs, 128), generator=gen, device=dev).to(torch.bfloat16),
            "value_cache": torch.randn((nb, 32, bs, 128), generator=gen, device=dev).to(torch.bfloat16),
            "block_tables": tables.to(dev), "seq_lens": torch.tensor(STEP_LENS, dtype=torch.int32, device=dev)}


def decode_ranks_ms(dargs: dict) -> dict:
    """Kernel 5 on ``dargs`` at every cluster size, 1 to 8, in place of its
    plan's (device ms, cold L2), each result within ``PAGED_TOL`` of the
    plain version; fails on a miss."""
    from paddle_tpu_torch.kernels import paged_attention as kp

    pargs = {k: v for k, v in dargs.items() if k not in ("cos", "sin")}
    atol, rel = PAGED_TOL[str(dargs["q"].dtype).split(".")[-1]]
    want = kp.paged_flash_decode_plain(**pargs)
    times = {}
    for ranks in range(1, 9):
        def run(ranks=ranks):
            return kp._decode_launch("paged_flash_decode", pargs["q"], None, None, pargs["key_cache"],
                                     pargs["value_cache"], pargs["block_tables"], pargs["seq_lens"], None, None,
                                     None, ranks=ranks)
        err, ok = within(run(), want, atol=atol, rel=rel)
        if not ok:
            fail(f"paged_decode at {ranks} ranks disagrees with its plain version (max abs err {err})")
        times[ranks] = device_ms(run)
    return times


def check_decode_gate(dev, gen, card: dict, records: dict) -> None:
    """Kernels 5 and 6 timed over :func:`decode_batch` (device ms, cold L2)
    at the 7B decode step's geometry (D 128, MHA 32/32) and at D 256, 320,
    512, 576 and 1024 (MHA 16/16), with bf16 pools and bf16 q over the
    int8 pool, and over :func:`step_batch` (the ``generate_paged`` step's
    uniform lengths, bf16): each beside the bound of this run's lengths
    (the int8 pool's scale rows counted), its share of it, the plain
    version and SDPA over the gathered K/V (dequantized to bf16 for the
    int8 pool; q roped for 6) with the ratio; beside 5 at D 128 bf16,
    ``read_floor_ms``: ``torch.sum`` over as many bf16 bytes, timed alike
    (the L2 flush leaves dirty lines that every read must write back
    first). Kernel 5 in bf16 at D 128 on both batches is also timed at
    every cluster size the plan can take (``ranks_ms``: 1 to 8 ranks, each
    result held to the plain version), beside the plan's own. One
    ``decode_gate`` line (each row with the plan's ``cluster_size`` and
    ``clusters_at_once``, the card's cap at 1 to 8 ranks); gated: every
    decode-batch instance up to D 512 at most ``DECODE_GATE`` x SDPA, and
    kernel 5 at D 128 bf16 at least ``DECODE_SHARE_GATE`` of its bound."""
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.kernels import paged_attention as kp

    rows, misses = {}, []
    cases = [(f"_d{d}", d, hkv, int8, lambda d=d, hq=hq, hkv=hkv: decode_batch(dev, gen, hq, hkv, d=d)[0])
             for d, hq, hkv in DECODE_TIMED for int8 in (False, True)]
    for tag, d, hkv, int8, make in cases + [("_step", 128, 32, False, lambda: step_batch(dev, gen))]:
        dargs = int8_pool(make()) if int8 else make()
        decode_agree(dargs, f"at D {d}{' over the int8 pool' * int8} (timed{tag})", [] if tag == "_step" else [6])
        lens = [int(n) for n in dargs["seq_lens"]]
        kd, vd, n_pos = (dequant_gathered if int8 else gathered_kv)(dargs, lens)
        mask = (torch.arange(n_pos, device=dev)[None, :] < dargs["seq_lens"][:, None])[:, None, None]
        plan = kp._decode_launch_plan(dargs["q"], dargs["key_cache"], dargs["block_tables"], False)
        for k, (run, run_plain) in decode_pairs(dargs).items():
            rope = k == "paged_decode_fused"
            qq = (kp.rope_rows(dargs["q"], dargs["cos"], dargs["sin"]) if rope else dargs["q"])[:, :, None]
            nbytes, flops = decode_cost(dargs, rope=rope)
            nbytes += 2 * hkv * 4 * sum(lens) * int8  # the scale rows
            ms = device_ms(run)
            lib = device_ms(lambda: tF.scaled_dot_product_attention(qq, kd, vd, attn_mask=mask))
            name = k + "_int8" * int8 + tag
            r = dict(source="paddle_tpu_torch/kernels/csrc/paged_decode.cu", d=d, hq=dargs["q"].shape[1], hkv=hkv,
                     ms=ms, plain_ms=device_ms(run_plain, iters=5), library_ms=lib, ratio_to_library=ms / lib,
                     sdpa_backend=sdpa_backend(qq, kd, vd, mask), bytes=nbytes, flops=flops, **bound(nbytes, flops),
                     cluster_size=plan["ranks"], clusters_at_once=plan["cap"])
            r["share_of_bound"] = r["bound_ms"] / ms
            if name == "paged_decode_d128":  # the floor of this timing: one bf16 read of as many bytes
                flat = torch.ones(nbytes // 2, dtype=torch.bfloat16, device=dev)
                r["read_floor_ms"] = device_ms(lambda: flat.sum())
                del flat
            if name in ("paged_decode_d128", "paged_decode_step"):
                r["ranks_ms"] = decode_ranks_ms(dargs)
            rows[name] = records[name] = r
            if tag != "_step" and d <= WIDE_HEAD_DIMS[-1] and r["ratio_to_library"] > DECODE_GATE:
                misses.append(f"{name}: {ms:.4f} ms, {r['ratio_to_library']:.2f}x SDPA")
            if name == "paged_decode_d128" and r["share_of_bound"] < DECODE_SHARE_GATE:
                misses.append(f"paged_decode at D 128: {r['share_of_bound']:.3f} of its bound")
        del kd, vd
    emit({"phase": "decode_gate", "gate": {"ratio_to_sdpa_at_most": DECODE_GATE, "d": [128, 256, 320, 512],
                                           "paged_decode_d128_share_at_least": DECODE_SHARE_GATE},
          "library": "SDPA over the gathered K/V (dequantized for the int8 pool; q roped for 6)",
          "instances": rows, "misses": misses, "card": card})
    if misses:
        fail(f"decode_gate: {'; '.join(misses)}")


def check_paged_fused(dev, gen, card: dict, records: dict) -> None:
    """Kernel A (rope-fused paged chunk attention) against its plain version
    over :func:`paged_batch`'s mixed batch at the 7B MHA geometry and GQA
    32/8, timed at 7B with SDPA over the gathered K/V as the yardstick."""
    import torch
    from paddle_tpu_torch.kernels.paged_attention import paged_flash_chunk_fused, paged_flash_chunk_fused_plain

    for hq, hkv in ((32, 32), (32, 8)):
        args, _ = paged_batch(dev, gen, hq, hkv)
        got = paged_flash_chunk_fused(**args)
        want = paged_flash_chunk_fused_plain(**args)
        torch.cuda.synchronize()
        err, ok = within(got, want, atol=1e-4, rel=BF16_REL)
        idle_zero = bool((got[6] == 0).all()) and bool((got[2, 1:] == 0).all())
        if not ok or not idle_zero:
            fail(f"paged_chunk_fused disagrees with its plain version at HQ={hq} HKV={hkv} "
                 f"(max abs err {err}, rows past q_lens zero: {idle_zero})")
        if hq != hkv:
            emit({"phase": "kernel_check", "kernel": "paged_chunk_fused", "hq": hq, "hkv": hkv,
                  "max_abs_err": err, "tolerance": "1e-4 + 2^-7*|x|", "card": card})
            continue
        nbytes, flops = paged_cost(args)
        run, run_plain = (lambda: paged_flash_chunk_fused(**args)), (lambda: paged_flash_chunk_fused_plain(**args))
        records["paged_chunk_fused"] = dict(
            source="paddle_tpu_torch/kernels/csrc/paged_chunk_fused.cu", max_abs_err=err,
            ms=device_ms(run), plain_ms=device_ms(run_plain, iters=5), library_ms=device_ms(chunk_sdpa(args)),
            call_ms=call_ms(run), plain_call_ms=call_ms(run_plain, iters=5), **bound(nbytes, flops),
        )
        emit({"phase": "kernel_check", "kernel": "paged_chunk_fused", "hq": hq, "hkv": hkv,
              "tolerance": "1e-4 + 2^-7*|x|", "bytes": nbytes, "flops": flops,
              **records["paged_chunk_fused"], "card": card})


def check_kernels(dev, card: dict) -> tuple:
    """Phase 3: every kernel against its plain version at the 7B serving
    shapes, with its times; returns the per-kernel records and the flash
    kernels' cold-L2 ms per call under each train step's mask
    (``check_flash``)."""
    import torch
    from paddle_tpu_torch.kernels.fused import (
        fused_embed_rms_norm, fused_embed_rms_norm_plain,
        fused_rms_norm_residual, fused_rms_norm_residual_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    records = {}

    check_paged_fused(dev, gen, card, records)

    # B: token gather + embedding + RMSNorm, ids [8, 64] over the 32000 x 4096 table
    table = (torch.randn((32000, 4096), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn((4096,), generator=gen, device=dev)).to(torch.bfloat16)
    ids = torch.randint(0, 32000, (8, 64), generator=gen, device=dev, dtype=torch.int32)
    ids[0, 0], ids[1, 1] = -5, 40000  # clipped to [0, V-1] by both versions
    (emb, y), (emb_p, y_p) = fused_embed_rms_norm(ids, table, w, 1e-5), fused_embed_rms_norm_plain(ids, table, w, 1e-5)
    torch.cuda.synchronize()
    err, ok = within(y, y_p, atol=0.0, rel=BF16_REL)
    exact = bool(torch.equal(emb, emb_p))
    if not ok or not exact:
        fail(f"embed_rms disagrees with its plain version (max abs err {err}, emb bitwise {exact})")
    n, h = ids.numel(), 4096
    run, run_plain = (lambda: fused_embed_rms_norm(ids, table, w, 1e-5)), (lambda: fused_embed_rms_norm_plain(ids, table, w, 1e-5))
    records["embed_rms"] = dict(
        source="paddle_tpu_torch/kernels/csrc/embed_rms.cu", max_abs_err=err,
        ms=device_ms(run), plain_ms=device_ms(run_plain), library_ms=None,
        call_ms=call_ms(run), plain_call_ms=call_ms(run_plain), **bound(n * 4 + 3 * n * h * 2 + h * 2, 4 * n * h, FP32_FLOP_PER_S),
    )
    emit({"phase": "kernel_check", "kernel": "embed_rms", "tolerance": "1 bf16 ulp; emb bitwise",
          **records["embed_rms"], "card": card})

    # C: residual add + RMSNorm over [8, 64, 4096]
    x = torch.randn((8, 64, 4096), generator=gen, device=dev).to(torch.bfloat16)
    res = (4 * torch.randn((8, 64, 4096), generator=gen, device=dev)).to(torch.bfloat16)
    (y, r), (y_p, r_p) = fused_rms_norm_residual(x, w, res, 1e-5), fused_rms_norm_residual_plain(x, w, res, 1e-5)
    torch.cuda.synchronize()
    err, ok = within(y, y_p, atol=0.0, rel=BF16_REL)
    exact = bool(torch.equal(r, r_p))
    if not ok or not exact:
        fail(f"rms_residual disagrees with its plain version (max abs err {err}, r bitwise {exact})")
    n = x.numel() // h
    run, run_plain = (lambda: fused_rms_norm_residual(x, w, res, 1e-5)), (lambda: fused_rms_norm_residual_plain(x, w, res, 1e-5))
    records["rms_residual"] = dict(
        source="paddle_tpu_torch/kernels/csrc/rms_residual.cu", max_abs_err=err,
        ms=device_ms(run), plain_ms=device_ms(run_plain), library_ms=None,
        call_ms=call_ms(run), plain_call_ms=call_ms(run_plain), **bound(4 * n * h * 2 + h * 2, 5 * n * h, FP32_FLOP_PER_S),
    )
    emit({"phase": "kernel_check", "kernel": "rms_residual", "tolerance": "1 bf16 ulp; r bitwise",
          **records["rms_residual"], "card": card})
    check_paged_new(dev, gen, card, records)
    check_paged_dtypes(dev, gen, card)
    check_decode_wide(dev, gen, card)
    check_decode_split(dev, gen, card)
    check_decode_gate(dev, gen, card, records)
    check_paged_split(dev, gen, card)
    check_chunk_plan(card)
    check_paged_wide(dev, gen, card, records)
    check_b_c_dtypes(dev, gen, card)
    check_append_sync(dev, gen, card)
    flash_cold = check_flash(dev, gen, card, records)
    check_norm_rope(dev, gen, card, records)
    check_residual_norms(dev, gen, card, records)
    check_fused_loss(dev, gen, card, records)
    check_int8_kernels(dev, gen, card, records)
    return records, flash_cold


def check_b_c_dtypes(dev, gen, card: dict) -> None:
    """Kernels B and C in fp16 and fp32 (ragged rows, H 384) against their
    plain versions: y within one ulp of the type (2^-10 of the value in
    fp16, 1e-5 in fp32: the same fp32 arithmetic, summed in another order),
    emb and r bitwise."""
    import torch
    from paddle_tpu_torch.kernels.fused import (
        fused_embed_rms_norm, fused_embed_rms_norm_plain,
        fused_rms_norm_residual, fused_rms_norm_residual_plain,
    )

    for dtype, rel in ((torch.float16, 2.0 ** -10), (torch.float32, 1e-5)):
        x = torch.randn((3, 77, 384), generator=gen, device=dev).to(dtype)
        res = torch.randn((3, 77, 384), generator=gen, device=dev).to(dtype)
        w = (1 + 0.1 * torch.randn((384,), generator=gen, device=dev)).to(dtype)
        table = torch.randn((1000, 384), generator=gen, device=dev).to(dtype)
        ids = torch.randint(-3, 1003, (5, 41), generator=gen, device=dev, dtype=torch.int32)
        (y, r), (y_p, r_p) = fused_rms_norm_residual(x, w, res, 1e-5), fused_rms_norm_residual_plain(x, w, res, 1e-5)
        (emb, ye), (emb_p, ye_p) = fused_embed_rms_norm(ids, table, w, 1e-5), fused_embed_rms_norm_plain(ids, table, w, 1e-5)
        torch.cuda.synchronize()
        err_c, ok_c = within(y, y_p, atol=0.0, rel=rel)
        err_b, ok_b = within(ye, ye_p, atol=0.0, rel=rel)
        exact = bool(torch.equal(r, r_p)) and bool(torch.equal(emb, emb_p))
        line = {"phase": "kernel_check", "kernel": "embed_rms/rms_residual", "dtype": str(dtype).split(".")[-1],
                "shape": [3, 77, 384], "max_abs_err": {"rms_residual": err_c, "embed_rms": err_b},
                "tolerance": f"y within {rel} relative; emb and r bitwise", "card": card}
        emit(line)
        if not (ok_c and ok_b and exact):
            fail(f"kernels B/C disagree with their plain versions in {dtype}: {line['max_abs_err']}, bitwise {exact}")


def run_sync_free(label: str, fn) -> None:
    """``fn()`` once to warm up, then once under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync raises."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as exc:
        fail(f"{label} synchronised with the host: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def mask_reference(kc, vc, k, v, tables, pos, valid):
    """Pools with rows ``k``/``v`` (``[N, H, D]``) written at positions
    ``pos`` where ``valid`` (``[N]`` each; tables row per entry ``[N, MBS]``),
    selected through a boolean mask (a host sync): the reference."""
    import torch

    bs = kc.shape[2]
    phys = torch.gather(tables.long(), 1, (pos.long() // bs).clamp(max=tables.shape[1] - 1)[:, None])[:, 0]
    want_k, want_v = kc.clone(), vc.clone()
    want_k[phys[valid], :, (pos.long() % bs)[valid]] = k[valid]
    want_v[phys[valid], :, (pos.long() % bs)[valid]] = v[valid]
    return want_k, want_v


def check_append_sync(dev, gen, card: dict, int8: bool = False) -> None:
    """The KV appends at the 7B serving shapes (32 KV heads of 128) run
    under ``torch.cuda.set_sync_debug_mode("error")``, so any host
    synchronisation raises, and must leave pools equal bit for bit to a
    boolean-mask reference: the serving step's chunk append (8 slots x 64
    rows, a masked slot and rows past q_lens), the decode append
    ``block_cache_append`` (a masked idle slot, garbage table tails) and the
    prompt write ``block_cache_prefill`` (lengths shorter than S, one 0).
    With ``int8`` the pools are the int8 pool's: the appends quantize their
    rows on the way in, and payload and scale planes must equal a
    boolean-mask write of the same quantized rows."""
    import torch
    from paddle_tpu_torch.incubate.nn.functional import (
        block_cache_append, block_cache_append_chunk, block_cache_prefill,
    )
    from paddle_tpu_torch.incubate.nn.functional.block_attention import _quantize_kv_rows

    names = ("key_cache", "value_cache", "k_scale", "v_scale") if int8 else ("key_cache", "value_cache")

    def reference(pools, k, v, tables, pos, valid):
        if not int8:
            return mask_reference(pools["key_cache"], pools["value_cache"], k, v, tables, pos, valid)
        (qk, sk), (qv, sv) = _quantize_kv_rows(k), _quantize_kv_rows(v)
        want = mask_reference(pools["key_cache"], pools["value_cache"], qk, qv, tables, pos, valid)
        scales = mask_reference(pools["k_scale"][..., None], pools["v_scale"][..., None], sk[..., None],
                                sv[..., None], tables, pos, valid)
        return (*want, *(t[..., 0] for t in scales))

    def run(label, fn, pools, want):
        got = [pools[n].clone() for n in names]
        planes = dict(key_scale=got[2], value_scale=got[3]) if int8 else {}
        run_sync_free(label + " (int8)" * int8, lambda: fn(*got[:2], **planes))
        return all(bool(torch.equal(g, w)) for g, w in zip(got, want))

    args, _ = paged_batch(dev, gen, 32, 32)
    pools = int8_pool(args) if int8 else args
    tables, lens, q_lens = (args[n] for n in ("block_tables", "seq_lens", "q_lens"))
    mask = torch.tensor([True, True, True, True, True, False, False, True], device=dev)
    k, v = (torch.randn(args["q"].shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    c = k.shape[1]
    j = torch.arange(c, device=dev)[None, :]
    valid = ((j < q_lens.long()[:, None]) & mask[:, None]).reshape(-1)
    results = {}
    want = reference(pools, flat_s(k), flat_s(v), tables.repeat_interleave(c, dim=0), (lens[:, None] + j).reshape(-1),
                     valid)
    results["block_cache_append_chunk"] = run("block_cache_append_chunk", lambda kc, vc, **pl: block_cache_append_chunk(
        kc, vc, k, v, tables, lens, q_lens, slot_mask=mask, **pl), pools, want)

    dargs, _ = decode_batch(dev, gen, 32, 32)
    dpools = int8_pool(dargs) if int8 else dargs
    tables = dargs["block_tables"]
    pos = (dargs["seq_lens"] - 1).clamp(min=0)
    dmask = torch.tensor([True, True, True, False, True, True, False, True], device=dev)
    k1, v1 = (torch.randn((8, 32, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    want = reference(dpools, k1, v1, tables, pos, dmask)
    results["block_cache_append"] = run("block_cache_append", lambda kc, vc, **pl: block_cache_append(
        kc, vc, k1, v1, tables, pos, slot_mask=dmask, **pl), dpools, want)

    s = 64
    plens = torch.tensor([1, 40, 64, 17, 64, 64, 0, 63], dtype=torch.int32, device=dev)
    kp, vp = (torch.randn((8, s, 32, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    t = torch.arange(s, device=dev)[None, :]
    want = reference(dpools, flat_s(kp), flat_s(vp), tables.repeat_interleave(s, dim=0), t.expand(8, s).reshape(-1),
                     (t < plens[:, None]).reshape(-1))
    results["block_cache_prefill"] = run("block_cache_prefill", lambda kc, vc, **pl: block_cache_prefill(
        kc, vc, kp, vp, tables, plens, **pl), dpools, want)
    emit({"phase": "append_sync_int8" if int8 else "append_sync", "chunk_shape": list(k.shape),
          "decode_shape": list(k1.shape), "prefill_shape": list(kp.shape), "sync_debug_mode": "error", "host_syncs": 0,
          "bitwise_equal_to_mask_reference": results, "card": card})
    if not all(results.values()):
        fail(f"a sync-free {'int8 ' * int8}KV append differs from the boolean-mask reference: {results}")


def flat_s(t):
    """``[B, S, H, D]`` as ``[B * S, H, D]``."""
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


# -- kernels 14-16: flash attention forward, dq, dk/dv ------------------------------

FLASH_TF32_SOURCE = "paddle_tpu_torch/kernels/csrc/flash_fwd_tf32.cu"  # the fp32 forward up to head dim 256
FLASH_BWD_TF32_SOURCE = "paddle_tpu_torch/kernels/csrc/flash_bwd_tf32.cu"  # fp32 dq and dk/dv up to head dim 256
FLASH_FP32_GATE = 1.0  # the fp32 forward at most this times SDPA's fp32 forward, GQA 32/8 [2, 1024] C=2 causal
FLASH_FP32_BWD_GATE = 1.0  # fp32 dq + dk/dv at most this times SDPA's fp32 backward, the same case

FLASH_SOURCES = {
    "flash_fwd": "paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
    "flash_bwd_dq": "paddle_tpu_torch/kernels/csrc/flash_bwd_dq.cu",
    "flash_bwd_dkv": "paddle_tpu_torch/kernels/csrc/flash_bwd_dkv.cu",
}
FLASH_FP32_SOURCE = "paddle_tpu_torch/kernels/csrc/flash_fp32.cu"
# the bf16 / fp16 forward, dq and dk/dv above head dim 256 (tensor cores; their own launch counters)
FLASH_WIDE_SOURCE = "paddle_tpu_torch/kernels/csrc/flash_fwd_wide.cu"
FLASH_BWD_WIDE_SOURCE = "paddle_tpu_torch/kernels/csrc/flash_bwd_wide.cu"
FLASH_WIDE_GATE = 1.0  # the wide forward at most this times SDPA's forward at D 320 and 512, GQA 8/2 [2, 1024] causal
# the wide dq + dk/dv at most this times SDPA's whole backward (dq, dk, dv) at D 320 and 512, the same cases
FLASH_BWD_WIDE_GATE = 1.0


def fwd_counter(d: int, dtype: str) -> str:
    """The launch counter of the flash forward at head dim ``d`` in ``dtype``
    (``"bfloat16"``...): ``flash_fwd_wide`` for bf16 / fp16 above 256."""
    return "flash_fwd_wide" if d > 256 and dtype in ("bfloat16", "float16") else "flash_fwd"


def bwd_counter(kernel: str, d: int, dtype: str) -> str:
    """The launch counter of the flash backward ``kernel`` (``"flash_bwd_dq"``
    or ``"flash_bwd_dkv"``) at head dim ``d`` in ``dtype``: with ``_wide``
    for bf16 / fp16 above 256 (``csrc/flash_bwd_wide.cu``)."""
    return f"{kernel}_wide" if d > 256 and dtype in ("bfloat16", "float16") else kernel
# out: the kernel rounds P to bf16 for the P V product (as flash attention
# does) while l sums the fp32 p, so each p moves by at most 2^-8 of itself and
# an output element out[i, e] by at most 2^-8 * (sum_j p_ij |v_je|) / l_i —
# the plain forward run on |v|, computed per element for each input; the
# rounding of out itself to bf16 is covered by one bf16 ulp of |x|
FLASH_TOL = {"out": "2^-8*(P|v|)/l per element + 2^-7*|x|", "lse": "1e-4 * max(1, |lse|)",
             "grads": "rel L2 <= 1e-2"}
# per input dtype: (P's rounding, out's ulp, lse rel, grads rel L2). fp16
# rounds P and out with a 10-bit significand: the bf16 gate with 2^-10 in
# place of both 2^-8 and 2^-7. fp32 rounds nothing: the kernel and its plain
# version differ only in the fp32 summation order (products over D <= 256,
# softmax sums over <= 4096 columns), ~1e-6 relative, so 1e-5 relative.
FLASH_GATES = {"bfloat16": (2.0**-8, 2.0**-7, 1e-4, 1e-2), "float16": (2.0**-10, 2.0**-10, 1e-4, 1e-2),
               "float32": (1e-5, 1e-5, 1e-5, 1e-5)}


def doc_bounds(rng, b: int, s: int, lo: int = 128, hi: int = 2048):
    """Document packing of ``b`` rows of ``s`` tokens, lengths uniform in
    ``lo..hi`` (the last one cut at ``s``): ``ends [b, s]``, each
    position's document end — the C=1 causal FlashMask bounds."""
    import numpy as np

    ends = np.zeros((b, s), np.int32)
    for i in range(b):
        pos = 0
        while pos < s:
            end = min(s, pos + int(rng.integers(lo, hi + 1)))
            ends[i, pos:end] = end
            pos = end
    return ends


def band_bounds(gen, dev, b: int, hm: int, s: int, c: int):
    """C=2 or C=4 FlashMask bounds ``[b, hm, s, c]`` that keep every row's
    diagonal: a band of rows below the diagonal (C=2), plus one above (C=4)."""
    import torch

    j = torch.arange(s, device=dev)
    start = (j + 1 + torch.randint(0, 256, (b, hm, s), generator=gen, device=dev)).clamp(max=s)
    end = (start + torch.randint(0, 512, (b, hm, s), generator=gen, device=dev)).clamp(max=s)
    cols = [start, end]
    if c == 4:
        ute = (j - 1 - torch.randint(0, 256, (b, hm, s), generator=gen, device=dev)).clamp(min=0)
        uts = (ute - torch.randint(0, 512, (b, hm, s), generator=gen, device=dev)).clamp(min=0)
        cols += [uts, ute]
    return torch.stack(cols, -1).to(torch.int32).contiguous()


def flash_cost(q, k, bounds, causal: bool) -> dict:
    """What this input's attention needs: visible (row, column) pairs summed
    over batch and query heads, the flops of each kernel (2 D flops per
    pair and product: forward 2 products, dq 3, dk/dv 4) at the peak of the
    inputs' type (fp32: the CUDA cores' 67 TFLOP/s) and the bytes each must
    move (inputs read once, outputs written once). The fp32 kernels up to
    head dim 256 (``csrc/flash_fwd_tf32.cu``, ``csrc/flash_bwd_tf32.cu``)
    run each product in three TF32 passes: their bound is those passes at
    the TF32 tensor peak, with the 67 TFLOP/s one-pass bound beside it
    (``bound_ms_cuda_cores``)."""
    import torch
    from paddle_tpu_torch.kernels.flash_attention import flash_fwd_fp32_plan, flash_masked

    b, sq, h, d = q.shape
    sk = k.shape[1]
    pairs = 0
    for bi in range(b):  # one batch row of the dense mask at a time
        mb = None if bounds is None else bounds[bi: bi + 1]
        vis = (~flash_masked(sq, sk, causal, mb, q.device)).sum(dim=(-1, -2))  # [1, Hm|1]
        pairs += int(vis.sum()) * (h // vis.numel())
    es = q.element_size()
    qb, kb = q.numel() * es, k.numel() * es  # q (= out, g, dq) and k (= v, dk, dv)
    stats = b * h * sq * 4  # one fp32 lse or delta
    mb = 0 if bounds is None else bounds.numel() * 4
    rate = FP32_FLOP_PER_S if q.dtype == torch.float32 else BF16_FLOP_PER_S
    tf32 = q.dtype == torch.float32 and d <= 512 and flash_fwd_fp32_plan(d)["walk"] == "tf32x3"
    out = {"pairs": pairs}
    # kernel: (bytes, products of 2 D flops a visible pair)
    for name, nbytes, products in (("flash_fwd", 2 * qb + 2 * kb + stats + mb, 2),
                                   ("flash_bwd_dq", 3 * qb + 2 * kb + 2 * stats + mb, 3),
                                   ("flash_bwd_dkv", 2 * qb + 4 * kb + 2 * stats + mb, 4)):
        one = bound(nbytes, 2 * products * d * pairs, rate)
        out[name] = one if not tf32 else {
            **bound(nbytes, 3 * 2 * products * d * pairs, TF32_FLOP_PER_S), "bound_ms_cuda_cores": one["bound_ms"],
            "bound_reckoned": f"3 TF32 passes of {2 * products} D flops a visible pair at 494.7 TFLOP/s "
                              "(cuda_cores: 1 pass at 67 TFLOP/s)"}
    return out


def flash_tiles(bounds, sq: int, sk: int, causal: bool, d: int, dtype) -> dict:
    """Per flash kernel (``flash_tile_classes``, the kernels' FlashMask
    tile classes, at each kernel's tile): SKIP / PARTIAL / FULL counts over the launch
    and the share of tiles visited (not SKIP) of all (query tile, key tile)
    pairs; per (batch, mask head), so Hm 1 counts once for all heads."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as kfa

    out = {}
    for name in FLASH_SOURCES:
        bm, bn = kfa.flash_tile_shape(name, d, dtype)
        cls = kfa.flash_tile_classes(bounds, sq, sk, bm, bn, causal)
        counts = [int((cls == c).sum()) for c in (kfa.SKIP, kfa.PARTIAL, kfa.FULL)]
        out[name] = {"tile": [bm, bn], "skip_partial_full": counts,
                     "visited_share": (counts[1] + counts[2]) / max(1, sum(counts))}
    return out


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def flash_case(dev, gen, b, s, h, hk, causal, bounds, label: str, card: dict, timed: bool = False,
               dtype=None, d: int = 128) -> dict:
    """Each flash kernel against its plain version run in fp32 on the same
    inputs (one batch row at a time, to bound the plain versions'
    ``[H, Sq, Sk]`` fp32 temporaries); the backward kernels get the same
    ``g``, ``lse`` and ``delta`` as their plain versions. Gates per input
    dtype: ``FLASH_GATES``. Fails on a miss."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as kfa

    dtype = dtype or torch.bfloat16
    p_ulp, out_ulp, lse_rel, grad_rel = FLASH_GATES[str(dtype)[6:]]
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, hk, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, hk, d), generator=gen, device=dev).to(dtype)
    g = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    out, lse = kfa.flash_fwd(q, k, v, bounds, causal)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = kfa.flash_bwd_dq(q, k, v, bounds, g, lse, delta, causal)
    dk, dv = kfa.flash_bwd_dkv(q, k, v, bounds, g, lse, delta, causal)
    torch.cuda.synchronize()
    err = {"out": 0.0, "lse": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}  # out: max abs; lse: max rel; grads: rel L2
    abs_err = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    # out's reading beside its limit: the worst err / limit, and the medians of |out| and of the limit
    out_check = {"worst_err_over_limit": 0.0, "median_abs_out": [], "median_limit": []}
    ok = True
    for i in range(b):
        sl = slice(i, i + 1)
        f32 = [t[sl].float() for t in (q, k, v)]
        bnd = None if bounds is None else bounds[sl]
        ref_out, ref_lse = kfa.flash_fwd_plain(*f32, bnd, causal)
        limit = p_ulp * kfa.flash_fwd_plain(f32[0], f32[1], f32[2].abs(), bnd, causal)[0]
        limit += out_ulp * torch.maximum(out[sl].float().abs(), ref_out.abs())
        diff = (out[sl].float() - ref_out).abs()
        ratio = float((diff / limit.clamp(min=1e-30)).max())
        ok &= ratio <= 1.0
        out_check["worst_err_over_limit"] = max(out_check["worst_err_over_limit"], ratio)
        out_check["median_abs_out"].append(float(ref_out.abs().median()))
        out_check["median_limit"].append(float(limit.median()))
        fin = torch.isfinite(ref_lse)
        ok &= bool(torch.equal(torch.isfinite(lse[sl]), fin))
        err["out"] = max(err["out"], float(diff.max()))
        del limit, diff
        if fin.any():
            rel = ((lse[sl] - ref_lse).abs() / ref_lse.abs().clamp(min=1.0))[fin]
            err["lse"] = max(err["lse"], float(rel.max()))
        del ref_out, ref_lse
        args = (*f32, bnd, g[sl].float(), lse[sl], delta[sl], causal)
        grads = {"dq": (dq[sl], kfa.flash_bwd_dq_plain(*args))}
        ref_dk, ref_dv = kfa.flash_bwd_dkv_plain(*args)
        grads.update(dk=(dk[sl], ref_dk), dv=(dv[sl], ref_dv))
        for name, (got, want) in grads.items():
            err[name] = max(err[name], rel_l2(got, want))
            abs_err[name] = max(abs_err[name], float((got.float() - want).abs().max()))
        del grads, ref_dk, ref_dv, args, f32
        torch.cuda.empty_cache()
    ok &= err["lse"] <= lse_rel and max(err["dq"], err["dk"], err["dv"]) <= grad_rel
    gate = FLASH_TOL if dtype == torch.bfloat16 else {
        "out": f"{p_ulp:g}*(P|v|)/l per element + {out_ulp:g}*|x|", "lse": f"{lse_rel:g} * max(1, |lse|)",
        "grads": f"rel L2 <= {grad_rel:g}"}
    line = {"phase": "kernel_check", "kernel": "flash_fwd/flash_bwd_dq/flash_bwd_dkv", "case": label,
            "dtype": str(dtype)[6:], "shape": [b, s, h, hk, d], "causal": causal,
            "mask": None if bounds is None else list(bounds.shape), "max_err": err,
            "out_check": out_check, "grad_max_abs_err": abs_err, "tolerance": gate}
    if not ok:
        emit({**line, "card": card})
        fail(f"flash kernels disagree with their plain versions ({label}): {err}")
    res = {"max_abs_err": {"flash_fwd": err["out"], "flash_bwd_dq": abs_err["dq"],
                           "flash_bwd_dkv": max(abs_err["dk"], abs_err["dv"])},
           "gate_reading": {"out_worst_err_over_limit": out_check["worst_err_over_limit"],
                            "lse_rel_err": err["lse"], "lse_limit": lse_rel,
                            "grads_rel_l2": {n: err[n] for n in ("dq", "dk", "dv")}, "grads_limit": grad_rel},
           "bwd_args": (q, k, v, bounds, g, lse, delta, causal)}
    if timed:
        cost = flash_cost(q, k, bounds, causal)
        tiles = flash_tiles(bounds, s, s, causal, d, dtype)
        runs = {
            "flash_fwd": (lambda: kfa.flash_fwd(q, k, v, bounds, causal),
                          lambda: kfa.flash_fwd_plain(q, k, v, bounds, causal)),
            "flash_bwd_dq": (lambda: kfa.flash_bwd_dq(q, k, v, bounds, g, lse, delta, causal),
                             lambda: kfa.flash_bwd_dq_plain(q, k, v, bounds, g, lse, delta, causal)),
            "flash_bwd_dkv": (lambda: kfa.flash_bwd_dkv(q, k, v, bounds, g, lse, delta, causal),
                              lambda: kfa.flash_bwd_dkv_plain(q, k, v, bounds, g, lse, delta, causal)),
        }
        times = {}
        for name, (run, run_plain) in runs.items():
            ms = device_ms(run, iters=10)
            times[name] = dict(ms=ms, call_ms=call_ms(run, iters=10),
                               plain_ms=device_ms(run_plain, iters=2, warmup=1), **cost[name],
                               share_of_bound=cost[name]["bound_ms"] / ms, tiles=tiles.get(name))
            torch.cuda.empty_cache()
        res.update(times=times, pairs=cost["pairs"], tensors=(q, k, v, g))
        line["times"] = times
        line["visible_pairs"] = cost["pairs"]
    emit({**line, "card": card})
    return res


def sdpa_ms(q, k, v, g, mask=None) -> dict:
    """Yardstick only (the port never calls it): PyTorch's
    ``scaled_dot_product_attention`` on the same inputs, forward, and its
    backward (dq, dk and dv together): with ``is_causal`` unmasked, or with
    ``mask`` (True where a logit is masked, ``[B, 1, S, S]``) given as the
    dense boolean ``attn_mask``. Under GQA, K and V are repeated to the
    query heads before the timed calls."""
    import torch
    import torch.nn.functional as tF

    qh, kh, vh, gh = (t.transpose(1, 2).contiguous() for t in (q, k, v, g))
    if kh.shape[1] != qh.shape[1]:
        kh, vh = (t.repeat_interleave(qh.shape[1] // kh.shape[1], dim=1) for t in (kh, vh))
    kw = {"is_causal": True} if mask is None else {"attn_mask": ~mask}
    fwd = device_ms(lambda: tF.scaled_dot_product_attention(qh, kh, vh, **kw), iters=10)
    qr, kr, vr = (t.detach().requires_grad_() for t in (qh, kh, vh))
    out = tF.scaled_dot_product_attention(qr, kr, vr, **kw)
    bwd = device_ms(lambda: torch.autograd.grad(out, (qr, kr, vr), gh, retain_graph=True), iters=10)
    return {"fwd": fwd, "bwd_dq_dk_dv": bwd}


def sdpa_backend(qh, kh, vh, attn_mask=None, is_causal: bool = False) -> str:
    """The backend PyTorch's dispatcher picks for SDPA on these ``[B, H, S,
    D]`` operands (``torch._fused_sdp_choice``; K/V repeated to the query
    heads under GQA, as the yardsticks give them), or "not known" where
    this PyTorch has no such query."""
    import torch

    if kh.shape[1] != qh.shape[1]:
        kh, vh = (t.repeat_interleave(qh.shape[1] // kh.shape[1], dim=1) for t in (kh, vh))
    try:
        from torch.nn.attention import SDPBackend

        return SDPBackend(torch._fused_sdp_choice(qh, kh, vh, attn_mask, 0.0, is_causal)).name
    except Exception as e:  # noqa: BLE001 - a yardstick's label only
        return f"not known ({type(e).__name__})"


# head dims above the wgmma kernels' 256, up to the template instances' 512: every one is held against the
# plain versions; 320 and 512, the two the wide_heads phase runs, are timed
WIDE_HEAD_DIMS = (320, 384, 448, 512)
WIDE_TIMED = (320, 512)
# head dims above 512 (the runtime-D kernels: csrc/flash_deep.cu, paged_chunk_deep.cu and 5 / 6, and the wide
# forward): checked and timed
DEEP_HEAD_DIMS = (576, 1024)
# kernels A and 4 also checked (not timed) at 2048 (16 resident tile rows) and, in fp32, at 2432 (the chunked walk)
DEEP_CHECKED = (2048, 2432)
FP32_WIDE_TIMED = (320, 512, 576, 1024)  # fp32 flash at these head dims timed beside SDPA's fp32, causal
# the wide forward with Q streamed beside K (above D 1152: csrc/flash_fwd_wide.cu `stream_q`), and the wide
# backward there (its resident pair streamed): checked against the plain versions, not timed
STREAM_Q_HEAD_DIM = 1280


def check_wide_plan(card: dict) -> None:
    """``csrc/flash_fwd_wide.cu``'s launch plan (``ptt_flash_fwd_wide_plan``:
    boxes, boxes a warpgroup, CTAs a query tile, stream_q, ring stages,
    shared-memory bytes) equals its Python mirror ``flash_fwd_wide_plan``,
    and ``csrc/flash_bwd_wide.cu``'s for dq and dk/dv
    (``ptt_flash_bwd_wide_plan``: boxes, boxes an owner, CTAs a tile,
    stream, ring stages, shared-memory bytes) its mirror
    ``flash_bwd_wide_plan``, at every multiple of 64 from 320 to 2048."""
    import ctypes
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels.flash_attention import flash_bwd_wide_plan, flash_fwd_wide_plan

    fn = build.kernel_fn("ptt_flash_fwd_wide_plan", [ctypes.c_int, ctypes.c_void_p])
    bwd = build.kernel_fn("ptt_flash_bwd_wide_plan", [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    wrong = {}
    for d in range(320, 2049, 64):
        buf = (ctypes.c_int * 6)()
        build.check(fn(d, buf), "ptt_flash_fwd_wide_plan")
        py = flash_fwd_wide_plan(d)
        want = [py["boxes"], py["nw"], py["split"], int(py["stream_q"]), py["stages"], py["smem"]]
        if list(buf) != want:
            wrong[f"flash_fwd {d}"] = {"kernel": list(buf), "python": want}
        for i, kernel in enumerate(("flash_bwd_dq", "flash_bwd_dkv")):
            buf = (ctypes.c_int * 6)()
            build.check(bwd(d, i, buf), "ptt_flash_bwd_wide_plan")
            py = flash_bwd_wide_plan(d, kernel)
            want = [py["boxes"], py["nw"], py["split"], int(py["stream"]), py["stages"], py["smem"]]
            if list(buf) != want:
                wrong[f"{kernel} {d}"] = {"kernel": list(buf), "python": want}
    emit({"phase": "flash_wide_plan_check", "d": [320, 2048], "ok": not wrong, "wrong": wrong,
          "d512": flash_fwd_wide_plan(512), "d1024": flash_fwd_wide_plan(1024),
          "bwd_d512": {k: flash_bwd_wide_plan(512, k) for k in ("flash_bwd_dq", "flash_bwd_dkv")},
          "bwd_d1024": {k: flash_bwd_wide_plan(1024, k) for k in ("flash_bwd_dq", "flash_bwd_dkv")}, "card": card})
    if wrong:
        fail(f"the wide flash plans disagree with the kernels' plans: {wrong}")


def check_fp32_plan(card: dict) -> None:
    """The fp32 forward's plan (``ptt_flash_fwd_fp32_plan`` in
    ``csrc/flash_fwd_tf32.cu``: the walk, and for the 3xTF32 walk its rows,
    keys, buffers and shared-memory bytes) equals its Python mirror
    ``flash_fwd_fp32_plan``, and the fp32 dq's and dk/dv's
    (``ptt_flash_bwd_fp32_plan`` in ``csrc/flash_bwd_tf32.cu``: the same
    and the CTA's warps) theirs, ``flash_bwd_fp32_plan``, at every multiple
    of 64 from 64 to 512: the 3xTF32 walks to 256, the CUDA cores (the walk
    alone) above."""
    import ctypes
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels.flash_attention import flash_bwd_fp32_plan, flash_fwd_fp32_plan

    fn = build.kernel_fn("ptt_flash_fwd_fp32_plan", [ctypes.c_int, ctypes.c_void_p])
    bwd = build.kernel_fn("ptt_flash_bwd_fp32_plan", [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    wrong, plans = {}, {}
    for d in range(64, 513, 64):
        buf = (ctypes.c_int * 5)()
        build.check(fn(d, buf), "ptt_flash_fwd_fp32_plan")
        py = flash_fwd_fp32_plan(d)
        want = ([0, py["rows"], py["keys"], py["stages"], py["smem"]] if py["walk"] == "tf32x3"
                else [1, 0, 0, 0, 0])
        plans[f"flash_fwd {d}"] = py
        if list(buf) != want:
            wrong[f"flash_fwd {d}"] = {"kernel": list(buf), "python": want}
        for i, kernel in enumerate(("flash_bwd_dq", "flash_bwd_dkv")):
            buf = (ctypes.c_int * 6)()
            build.check(bwd(d, i, buf), "ptt_flash_bwd_fp32_plan")
            py = flash_bwd_fp32_plan(d, kernel)
            want = ([0, py["rows"], py["keys"], py["stages"], py["smem"], py["warps"]] if py["walk"] == "tf32x3"
                    else [1, 0, 0, 0, 0, 0])
            plans[f"{kernel} {d}"] = py
            if list(buf) != want:
                wrong[f"{kernel} {d}"] = {"kernel": list(buf), "python": want}
    emit({"phase": "flash_fp32_plan_check", "d": [64, 512], "ok": not wrong, "wrong": wrong, "plans": plans,
          "card": card})
    if wrong:
        fail(f"the fp32 flash plans disagree with the kernels': {wrong}")


def check_flash_wide(dev, gen, card: dict, records: dict) -> dict:
    """Kernels 14-16 at head dims 320, 384, 448 and 512 and 576 and 1024 at
    GQA 8/2, S 1024, causal and under a document mask, against their plain
    versions (``FLASH_GATES``): bf16 and fp16 on the tensor cores (the
    forward ``csrc/flash_fwd_wide.cu``, dq and dk/dv
    ``csrc/flash_bwd_wide.cu``; dk/dv's K and V stream through its ring
    from D 576, dq's Q and g at 1024), fp32 on the CUDA cores
    (``csrc/flash_fp32.cu`` to 512, ``csrc/flash_deep.cu`` above; at 1024
    causal only), causal at 320, 512, 576 and 1024 timed beside SDPA's fp32
    forward and backward with no gate; the bf16 cases at 320, 512, 576 and
    1024 timed beside SDPA (its
    backend named), the forward gated at :data:`FLASH_WIDE_GATE` x SDPA's
    forward and dq + dk/dv at :data:`FLASH_BWD_WIDE_GATE` x SDPA's whole
    backward, causal at 320 and 512, dk/dv bitwise equal over two calls at
    512; all three at D 1280 (the forward's Q streamed beside K) in bf16
    and fp16; and 320 and 512 at the ``wide_heads`` train step's S 4096
    under a document mask, bf16, timed. Records the D 512 causal readings
    as ``flash_fwd_wide``, ``flash_bwd_dq_wide`` and
    ``flash_bwd_dkv_wide``. Returns the times."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels import flash_attention as kfa
    from paddle_tpu_torch.kernels.flash_attention import flash_masked

    check_wide_plan(card)
    ends = torch.from_numpy(doc_bounds(np.random.default_rng(2), 2, 1024, 64, 512)[:, None, :, None].copy()).to(dev)
    wide, wide_err, deterministic, fp32_wide = {}, {}, {}, {}
    cases = [(d, dtype) for d in (*WIDE_HEAD_DIMS, *DEEP_HEAD_DIMS)
             for dtype in {dt for dt, _ in wide_dtypes(d)} | {torch.float16}]
    for d, dtype in cases + [(DEEP_HEAD_DIMS[-1], torch.float32)]:
        for bnd, mask in ((None, "causal"), (ends, "document mask")):
            if dtype == torch.float32 and d == DEEP_HEAD_DIMS[-1] and bnd is not None:
                continue  # fp32 at 1024: the timed causal case only
            timed = dtype == torch.bfloat16 and d in (*WIDE_TIMED, *DEEP_HEAD_DIMS)
            timed_fp32 = dtype == torch.float32 and bnd is None and d in FP32_WIDE_TIMED
            res = flash_case(dev, gen, 2, 1024, 8, 2, True, bnd, f"gqa 8/2, D {d}, {mask}, {str(dtype)[6:]}",
                             card, timed=timed or timed_fp32, dtype=dtype, d=d)
            if timed_fp32:  # the CUDA-core fp32 kernels beside SDPA in fp32 (TF32 off), no gate
                fp32_wide[f"d{d} causal"] = {
                    "times": {n: {k: t[k] for k in ("ms", "bound_ms", "bound_by", "share_of_bound", "plain_ms")}
                              for n, t in res["times"].items()},
                    "sdpa_ms": sdpa_ms(*res["tensors"]),
                    "source": FLASH_FP32_SOURCE if d <= 512 else "paddle_tpu_torch/kernels/csrc/flash_deep.cu"}
            if dtype != torch.float32:
                for name, err in res["max_abs_err"].items():
                    wide_err[name] = max(wide_err.get(name, 0.0), err)
            if timed:
                dense = None if bnd is None else flash_masked(1024, 1024, True, bnd, dev)
                qh, kh, vh = (t.transpose(1, 2) for t in res["tensors"][:3])
                wide[f"d{d} {mask}"] = {
                    "times": res["times"], "sdpa_ms": sdpa_ms(*res["tensors"], mask=dense),
                    "sdpa_backend": sdpa_backend(qh, kh, vh, None if dense is None else ~dense, dense is None)}
                if d == 512 and bnd is None:
                    deterministic["d512 causal"] = dkv_deterministic(res["bwd_args"])
            del res
            torch.cuda.empty_cache()
    # D 1280: the forward's Q streamed beside K (the backward streams its resident pair there too), against
    # the plain versions
    d = STREAM_Q_HEAD_DIM
    stream = {}
    for dtype in (torch.bfloat16, torch.float16):
        p_ulp, out_ulp, lse_rel, grad_rel = FLASH_GATES[str(dtype)[6:]]
        q, g = (torch.randn((1, 512, 4, d), generator=gen, device=dev).to(dtype) for _ in range(2))
        k, v = (torch.randn((1, 512, 2, d), generator=gen, device=dev).to(dtype) for _ in range(2))
        out, lse = kfa.flash_fwd(q, k, v, None, True)
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = kfa.flash_bwd_dq(q, k, v, None, g, lse, delta, True)
        dk, dv = kfa.flash_bwd_dkv(q, k, v, None, g, lse, delta, True)
        f32 = [t.float() for t in (q, k, v)]
        ref, ref_lse = kfa.flash_fwd_plain(*f32, None, True)
        limit = p_ulp * kfa.flash_fwd_plain(f32[0], f32[1], f32[2].abs(), None, True)[0] + out_ulp * ref.abs()
        lse_err = float(((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max())
        ratio = float(((out.float() - ref).abs() / limit.clamp(min=1e-30)).max())
        args = (*f32, None, g.float(), lse, delta, True)
        ref_dk, ref_dv = kfa.flash_bwd_dkv_plain(*args)
        grads = {"dq": rel_l2(dq, kfa.flash_bwd_dq_plain(*args)), "dk": rel_l2(dk, ref_dk), "dv": rel_l2(dv, ref_dv)}
        stream[str(dtype)[6:]] = {"worst_err_over_limit": ratio, "lse_rel_err": lse_err,
                                  "max_abs_err": float((out.float() - ref).abs().max()), "grads_rel_l2": grads}
        if ratio > 1.0 or lse_err > lse_rel or max(grads.values()) > grad_rel:
            emit({"phase": "flash_wide_stream_q", "d": d, "cases": stream, "card": card})
            fail(f"the wide kernels at D {d} ({dtype}) disagree with their plain versions: {stream}")
        del q, k, v, g, out, lse, delta, dq, dk, dv, ref, ref_lse, limit, f32, args, ref_dk, ref_dv
        torch.cuda.empty_cache()
    # the wide_heads train step's attention: S 4096 under a document mask, at the head dims it runs
    long_ends = torch.from_numpy(doc_bounds(np.random.default_rng(3), 2, 4096)[:, None, :, None].copy()).to(dev)
    long = {}
    for d in WIDE_TIMED:
        res = flash_case(dev, gen, 2, 4096, 8, 2, True, long_ends, f"gqa 8/2, D {d}, S 4096, document mask", card,
                         timed=True, dtype=torch.bfloat16, d=d)
        long[f"d{d}"] = {n: {k: t[k] for k in ("ms", "bound_ms", "share_of_bound", "plain_ms")}
                         for n, t in res["times"].items()}
        del res
        torch.cuda.empty_cache()
    ratios = {d: wide[f"d{d} causal"]["times"]["flash_fwd"]["ms"] / wide[f"d{d} causal"]["sdpa_ms"]["fwd"]
              for d in (*WIDE_TIMED, *DEEP_HEAD_DIMS)}
    bwd_ratios = {d: (wide[f"d{d} causal"]["times"]["flash_bwd_dq"]["ms"]
                      + wide[f"d{d} causal"]["times"]["flash_bwd_dkv"]["ms"])
                  / wide[f"d{d} causal"]["sdpa_ms"]["bwd_dq_dk_dv"] for d in (*WIDE_TIMED, *DEEP_HEAD_DIMS)}
    emit({"phase": "flash_wide_times", "shape": [2, 1024, 8, 2], "dtype": "bfloat16", "cases": wide,
          "stream": {"d": STREAM_Q_HEAD_DIM, "shape": [1, 512, 4, 2], "cases": stream},
          "s4096_document_mask": long,
          "fp32_causal": fp32_wide, "fp32_note": "fp32 on the CUDA cores (TF32 off), bound at 67 TFLOP/s; SDPA in "
                                                  "fp32 with is_causal, forward and backward; no gate",
          "source": {"forward (bf16, fp16)": FLASH_WIDE_SOURCE, "dq, dk/dv (bf16, fp16)": FLASH_BWD_WIDE_SOURCE,
                     "fp32 320-512": FLASH_FP32_SOURCE, "fp32 above 512": "paddle_tpu_torch/kernels/csrc/flash_deep.cu"},
          "fwd_over_sdpa_causal": ratios, "dq_plus_dkv_over_sdpa_bwd_causal": bwd_ratios,
          "dkv_bitwise_deterministic": deterministic,
          "gate": {"fwd_over_sdpa_at_most": FLASH_WIDE_GATE, "dq_plus_dkv_over_sdpa_bwd_at_most": FLASH_BWD_WIDE_GATE,
                   "d": list(WIDE_TIMED)},
          "card": card})
    case = wide["d512 causal"]
    for name, kernel, source in (("flash_fwd_wide", "flash_fwd", FLASH_WIDE_SOURCE),
                                 ("flash_bwd_dq_wide", "flash_bwd_dq", FLASH_BWD_WIDE_SOURCE),
                                 ("flash_bwd_dkv_wide", "flash_bwd_dkv", FLASH_BWD_WIDE_SOURCE)):
        t = case["times"][kernel]
        records[name] = dict(
            source=source, max_abs_err=wide_err[kernel], ms=t["ms"], plain_ms=t["plain_ms"], call_ms=t["call_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=case["sdpa_ms"]["fwd" if kernel == "flash_fwd" else "bwd_dq_dk_dv"],
            ms_by_case={m: c["times"][kernel]["ms"] for m, c in wide.items()})
    slow = {d: r for d, r in ratios.items() if d in WIDE_TIMED and r > FLASH_WIDE_GATE}
    if slow:
        fail(f"the wide forward is above {FLASH_WIDE_GATE}x SDPA's forward (causal, GQA 8/2 [2, 1024]): {slow}")
    slow = {d: r for d, r in bwd_ratios.items() if d in WIDE_TIMED and r > FLASH_BWD_WIDE_GATE}
    if slow:
        fail(f"the wide dq + dk/dv are above {FLASH_BWD_WIDE_GATE}x SDPA's whole backward (causal, GQA 8/2 "
             f"[2, 1024]): {slow}")
    if not all(deterministic.values()):
        fail(f"flash_bwd_dkv_wide: two runs on the same inputs differ ({deterministic})")
    return wide


def flash_cold_ms(dev, gen, b: int, s: int, h: int, causal: bool) -> dict:
    """Each flash kernel's device time per call with a cold L2 (``device_ms``)
    at ``[b, s, h, 128]`` bf16, no FlashMask: the GPT train step's attention,
    for the in-step reading of ``profile_train_step``."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as kfa

    q, k, v, g = (torch.randn((b, s, h, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(4))
    out, lse = kfa.flash_fwd(q, k, v, None, causal)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return {"flash_fwd": device_ms(lambda: kfa.flash_fwd(q, k, v, None, causal), iters=10),
            "flash_bwd_dq": device_ms(lambda: kfa.flash_bwd_dq(q, k, v, None, g, lse, delta, causal), iters=10),
            "flash_bwd_dkv": device_ms(lambda: kfa.flash_bwd_dkv(q, k, v, None, g, lse, delta, causal), iters=10)}


def dkv_deterministic(args, dq: bool = False) -> bool:
    """Kernel 16 twice on the same inputs: dk and dv bitwise equal (no
    atomics, a fixed order per work item whatever CTA takes it); with
    ``dq`` kernel 15's dq too."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as kfa

    dk0, dv0 = kfa.flash_bwd_dkv(*args)
    dk1, dv1 = kfa.flash_bwd_dkv(*args)
    same = bool(torch.equal(dk0, dk1)) and bool(torch.equal(dv0, dv1))
    return same and (not dq or bool(torch.equal(kfa.flash_bwd_dq(*args), kfa.flash_bwd_dq(*args))))


def check_flash(dev, gen, card: dict, records: dict) -> dict:
    """Kernels 14-16 at the train shape ``[2, 4096, 32, 128]`` causal, with
    no mask (timed, with the SDPA yardstick) and with the train phase's
    document mask (timed, with SDPA given the dense document mask), then at
    a GQA geometry (HQ 32 / HKV 8, S 1024) with C=2 causal and C=4
    non-causal masks for Hm 1 and H, at a ragged S of 1000 with a document
    mask, at S 4096 with C=2 and C=4 (HQ 8 / HKV 2), in fp16 and fp32 at the
    GQA geometry (C=2 causal timed, with SDPA given the dense band mask;
    C=4 non-causal), fp32 also unmasked causal (timed), at head dims 64,
    192 and 256 (256 timed), at the ragged S, at the fp32 train step's own
    shape and document mask (timed), at the eval loss's MHA ``[2, 2048]``
    and at S 4096 causal, and at head dims 64, 192 and 256 in
    bf16 (256 timed, with SDPA). Kernel 16's gates: at most SDPA's whole backward causal at the
    train shape, at most half its own causal time under the document mask,
    and two runs bitwise equal (causal and document mask). The fp32 gates
    (C=2 causal): the forward at most SDPA's fp32 forward, dq + dk/dv at
    most its fp32 backward, and dq and dk/dv bitwise over two runs (S 4096
    causal, the ragged and the train shape's document masks). Returns each
    kernel's cold-L2 ms per call under the Llama steps' mask (the document
    mask; bf16 and fp32) and at the GPT step's causal ``[4, 2048, 40, 128]``,
    for the train profiles' in-step readings."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels.flash_attention import flash_masked

    check_fp32_plan(card)
    plain = flash_case(dev, gen, 2, 4096, 32, 32, True, None, "train shape, causal", card, timed=True)
    lib = sdpa_ms(*plain["tensors"])
    ends = doc_bounds(np.random.default_rng(0), 2, 4096)
    doc = torch.from_numpy(ends[:, None, :, None].copy()).to(dev)
    masked = flash_case(dev, gen, 2, 4096, 32, 32, True, doc, "train shape, document mask", card, timed=True)
    lib_doc = sdpa_ms(*masked["tensors"], mask=flash_masked(4096, 4096, True, doc, dev))
    deterministic = {"causal": dkv_deterministic(plain["bwd_args"]),
                     "document mask": dkv_deterministic(masked["bwd_args"])}
    del plain["tensors"], masked["tensors"], plain["bwd_args"], masked["bwd_args"]
    torch.cuda.empty_cache()
    for c, causal in ((2, True), (4, False)):
        for hm in (1, 32):
            flash_case(dev, gen, 2, 1024, 32, 8, causal, band_bounds(gen, dev, 2, hm, 1024, c),
                       f"gqa 32/8, C={c}, Hm={hm}", card)
    ragged = torch.from_numpy(doc_bounds(np.random.default_rng(1), 2, 1000)[:, None, :, None].copy()).to(dev)
    flash_case(dev, gen, 2, 1000, 32, 8, True, ragged, "gqa 32/8, ragged S 1000, document mask", card)
    for c, causal in ((2, True), (4, False)):  # walks of 32 key tiles: several staging rounds of bounds
        flash_case(dev, gen, 1, 4096, 8, 2, causal, band_bounds(gen, dev, 1, 8, 4096, c),
                   f"gqa 8/2, S 4096, C={c}, Hm=H", card)
    extra, extra_lib, fp32_readings = {}, {}, {}
    for dtype in (torch.float16, torch.float32):
        for c, causal in ((2, True), (4, False)):
            bnd = band_bounds(gen, dev, 2, 1, 1024, c)
            res = flash_case(dev, gen, 2, 1024, 32, 8, causal, bnd, f"gqa 32/8, C={c}, {str(dtype)[6:]}", card,
                             timed=causal, dtype=dtype)
            if dtype == torch.float32:
                fp32_readings[f"C={c} {'causal' if causal else 'full'}"] = res["gate_reading"]
            if causal:
                extra[str(dtype)[6:]] = res["times"]
                extra_lib[str(dtype)[6:]] = sdpa_ms(*res["tensors"], mask=flash_masked(1024, 1024, True, bnd, dev))
    fp32_sdpa = {"C=2 causal": extra_lib["float32"]}
    fp32_backend = {"C=2 causal": "dense band mask as attn_mask"}
    # the fp32 kernels (csrc/flash_fwd_tf32.cu, csrc/flash_bwd_tf32.cu to D 256): unmasked causal at the same shape
    # beside SDPA's is_causal, every head dim of their walks, a ragged S under a document mask, the eval shape and
    # S 4096
    res = flash_case(dev, gen, 2, 1024, 32, 8, True, None, "gqa 32/8, causal, float32", card, timed=True,
                     dtype=torch.float32)
    fp32_readings["causal"] = res["gate_reading"]
    extra["float32 causal"] = res["times"]
    fp32_sdpa["causal"] = extra_lib["float32 causal"] = sdpa_ms(*res["tensors"])
    qh, kh, vh = (t.transpose(1, 2) for t in res["tensors"][:3])
    fp32_backend["causal"] = sdpa_backend(qh, kh, vh, None, True)
    del res, qh, kh, vh
    for d in (64, 192, 256):
        bnd = band_bounds(gen, dev, 2, 1, 1024, 2)
        res = flash_case(dev, gen, 2, 1024, 32, 8, True, bnd, f"gqa 32/8, C=2, D {d}, float32", card,
                         timed=d == 256, dtype=torch.float32, d=d)
        fp32_readings[f"C=2 causal D {d}"] = res["gate_reading"]
        if d == 256:
            extra["float32 d256"] = res["times"]
            fp32_sdpa["C=2 causal D 256"] = extra_lib["float32 d256"] = sdpa_ms(
                *res["tensors"], mask=flash_masked(1024, 1024, True, bnd, dev))
        del res
    res = flash_case(dev, gen, 2, 1000, 32, 8, True, ragged, "gqa 32/8, ragged S 1000, document mask, float32", card,
                     dtype=torch.float32)
    fp32_readings["ragged S 1000, document mask"] = res["gate_reading"]
    # dq and dk/dv (csrc/flash_bwd_tf32.cu) twice on the same inputs: the same bits, causal and document mask
    fp32_det = {"document mask": dkv_deterministic(res["bwd_args"], dq=True)}
    del res
    # the fp32 train step's own attention (train_fp32): MHA 32/32 [2, 4096] under the same document mask, timed
    # cold for that phase's in-step readings
    res = flash_case(dev, gen, 2, 4096, 32, 32, True, doc, "train shape, document mask, float32", card, timed=True,
                     dtype=torch.float32)
    fp32_readings["train shape, document mask"] = res["gate_reading"]
    fp32_det["train shape, document mask"] = dkv_deterministic(res["bwd_args"], dq=True)
    fp32_cold = {n: res["times"][n]["ms"] for n in FLASH_SOURCES}
    del res
    torch.cuda.empty_cache()
    # the shape the eval loss gives the forward (MHA 32/32, [2, 2048]) and a longer walk (S 4096): O sums over
    # every key tile of a row's walk, so the error is read at the lengths the main path reaches and beyond
    for b, s, label in ((2, 2048, "eval shape, causal"), (1, 4096, "mha 32/32, S 4096, causal")):
        res = flash_case(dev, gen, b, s, 32, 32, True, None, f"{label}, float32", card, dtype=torch.float32)
        fp32_readings[label] = res["gate_reading"]
        if b == 1:
            fp32_det["causal"] = dkv_deterministic(res["bwd_args"], dq=True)
        del res
    timed_cases = (("C=2 causal", "float32"), ("causal", "float32 causal"), ("C=2 causal D 256", "float32 d256"))
    fp32_ratio = {case: extra[key]["flash_fwd"]["ms"] / fp32_sdpa[case]["fwd"] for case, key in timed_cases}
    fp32_bwd_ratio = {case: (extra[key]["flash_bwd_dq"]["ms"] + extra[key]["flash_bwd_dkv"]["ms"])
                      / fp32_sdpa[case]["bwd_dq_dk_dv"] for case, key in timed_cases}
    readings = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_ms_cuda_cores", "share_of_bound")
    emit({"phase": "flash_fp32_tf32x3", "shape": [2, 1024, 32, 8, 128],
          "source": {"flash_fwd": FLASH_TF32_SOURCE, "flash_bwd_dq, flash_bwd_dkv": FLASH_BWD_TF32_SOURCE},
          "arithmetic": "q k^T and P V (forward); S, dP, dq = dS K, dV = P^T g, dK = dS^T q (backward) in 3 TF32 "
                        "passes of split operands (hi = tf32(x), lo = tf32(x - hi))",
          "gate_readings": fp32_readings, "limits": {"out": "1e-5*(P|v|)/l per element + 1e-5*|x|",
                                                     "lse": "1e-5 * max(1, |lse|)", "grads": "rel L2 <= 1e-5"},
          **{name[6:]: {case: {k: extra[key][name].get(k) for k in readings} for case, key in timed_cases}
             for name in FLASH_SOURCES},
          "sdpa_ms": fp32_sdpa, "sdpa_backend": fp32_backend, "fwd_over_sdpa_fwd": fp32_ratio,
          "dq_plus_dkv_over_sdpa_bwd": fp32_bwd_ratio, "bwd_bitwise_deterministic": fp32_det,
          "gate": {"fwd_over_sdpa_fwd_at_most": FLASH_FP32_GATE, "dq_plus_dkv_over_sdpa_bwd_at_most":
                   FLASH_FP32_BWD_GATE, "case": "C=2 causal"}, "card": card})
    if fp32_ratio["C=2 causal"] > FLASH_FP32_GATE:
        fail(f"the fp32 flash forward takes {fp32_ratio['C=2 causal']:.3f}x SDPA's fp32 forward (GQA 32/8 [2, 1024], "
             f"C=2 causal), above {FLASH_FP32_GATE}x")
    if fp32_bwd_ratio["C=2 causal"] > FLASH_FP32_BWD_GATE:
        fail(f"the fp32 flash dq + dk/dv take {fp32_bwd_ratio['C=2 causal']:.3f}x SDPA's fp32 backward (GQA 32/8 "
             f"[2, 1024], C=2 causal), above {FLASH_FP32_BWD_GATE}x")
    if not all(fp32_det.values()):
        fail(f"the fp32 flash dq / dk/dv: two runs on the same inputs differ ({fp32_det})")
    for d in (64, 192, 256):
        bnd = band_bounds(gen, dev, 2, 1, 1024, 2)
        res = flash_case(dev, gen, 2, 1024, 32, 8, True, bnd, f"gqa 32/8, C=2, D {d}", card, timed=d == 256, d=d)
        if d == 256:
            extra["d256"] = res["times"]
            extra_lib["d256"] = sdpa_ms(*res["tensors"], mask=flash_masked(1024, 1024, True, bnd, dev))
    del res
    torch.cuda.empty_cache()
    wide = check_flash_wide(dev, gen, card, records)
    for name in FLASH_SOURCES:
        t = plain["times"][name]
        records[name] = dict(
            source=FLASH_SOURCES[name], max_abs_err=plain["max_abs_err"][name],
            ms=t["ms"], plain_ms=t["plain_ms"], call_ms=t["call_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=lib["fwd"] if name == "flash_fwd" else lib["bwd_dq_dk_dv"],
            doc_mask_ms=masked["times"][name]["ms"], doc_mask_bound_ms=masked["times"][name]["bound_ms"],
            doc_mask_library_ms=lib_doc["fwd"] if name == "flash_fwd" else lib_doc["bwd_dq_dk_dv"],
            wide_ms={m: c["times"][name]["ms"] for m, c in wide.items()},
            sources={"bf16 / fp16 D <= 256": FLASH_SOURCES[name],
                     "fp32 D <= 256": FLASH_TF32_SOURCE if name == "flash_fwd" else FLASH_BWD_TF32_SOURCE,
                     "fp32 D 320-512": FLASH_FP32_SOURCE,
                     "fp32 D > 512": "paddle_tpu_torch/kernels/csrc/flash_deep.cu"},
        )
    dkv = records["flash_bwd_dkv"]
    cold = {"llama, document mask [2, 4096, 32, 128]": {n: records[n]["doc_mask_ms"] for n in FLASH_SOURCES},
            "llama fp32, document mask [2, 4096, 32, 128]": fp32_cold,
            "gpt, causal [4, 2048, 40, 128]": flash_cold_ms(dev, gen, 4, 2048, 40, True)}
    emit({"phase": "flash_times", "train_shape": [2, 4096, 32, 128],
          "library": "torch scaled_dot_product_attention: is_causal=True unmasked; the dense boolean document "
                     "(or band) mask as attn_mask; GQA K/V repeated to the query heads; bwd is dq+dk+dv in one figure",
          "sdpa_ms": lib, "sdpa_doc_mask_ms": lib_doc, "records": {n: records[n] for n in FLASH_SOURCES},
          "doc_over_causal": {n: records[n]["doc_mask_ms"] / records[n]["ms"] for n in FLASH_SOURCES},
          "fwd_over_sdpa": records["flash_fwd"]["ms"] / lib["fwd"],
          "dq_over_sdpa_bwd": records["flash_bwd_dq"]["ms"] / lib["bwd_dq_dk_dv"],
          "dkv_over_sdpa_bwd": dkv["ms"] / lib["bwd_dq_dk_dv"],
          "dq_plus_dkv_over_sdpa_bwd": (records["flash_bwd_dq"]["ms"] + dkv["ms"]) / lib["bwd_dq_dk_dv"],
          "dkv_share_of_bound": {"causal": dkv["bound_ms"] / dkv["ms"],
                                 "document mask": dkv["doc_mask_bound_ms"] / dkv["doc_mask_ms"]},
          "dkv_doc_over_causal": dkv["doc_mask_ms"] / dkv["ms"], "dkv_bitwise_deterministic": deterministic,
          "gqa_1024_c2_causal": extra, "gqa_1024_c2_causal_sdpa_ms": extra_lib,
          "fp32_source": {"forward to D 256": FLASH_TF32_SOURCE, "dq, dk/dv to D 256": FLASH_BWD_TF32_SOURCE,
                          "all three at 320-512": FLASH_FP32_SOURCE},
          "cold_ms_per_call": cold,
          "doc_mask_visible_pairs": masked["pairs"], "causal_visible_pairs": plain["pairs"], "card": card})
    if not all(deterministic.values()):
        fail(f"flash_bwd_dkv: two runs on the same inputs differ ({deterministic})")
    if dkv["ms"] > lib["bwd_dq_dk_dv"]:
        fail(f"flash_bwd_dkv takes {dkv['ms']:.4f} ms causal, above SDPA's whole backward "
             f"({lib['bwd_dq_dk_dv']:.4f} ms)")
    if dkv["doc_mask_ms"] > 0.5 * dkv["ms"]:
        fail(f"flash_bwd_dkv takes {dkv['doc_mask_ms']:.4f} ms under the document mask, above half of its "
             f"causal {dkv['ms']:.4f} ms: its tiles are not skipped")
    return cold


# -- kernels 7-10: RMSNorm forward/backward, rope forward/adjoint ---------------

NORM_ROPE_SOURCES = {
    "rms_norm_fwd": "paddle_tpu_torch/kernels/csrc/rms_norm.cu",
    "rms_norm_bwd": "paddle_tpu_torch/kernels/csrc/rms_norm.cu",
    "rope_fwd": "paddle_tpu_torch/kernels/csrc/rope.cu",
    "rope_bwd": "paddle_tpu_torch/kernels/csrc/rope.cu",
}
# rel is one ulp of the I/O type (2^-7 of the value in bf16, 2^-10 in
# fp16) and 1e-5 in fp32: both
# versions round the same fp32 arithmetic once, summed in other orders. dx
# adds 1e-5 of its largest value, since gw - x^ * mean cancels; dw adds
# 1e-5 of each column's sum of |g x^|, the scale of a reordered fp32 sum
NORM_ROPE_TOL = {
    "rms_norm_fwd": "y: rel*max(|x|); rstd: 1e-5 relative",
    "rms_norm_bwd": "dx: rel*|x| + 1e-5*max|dx|; dw: rel*|x| + 1e-5*sum_rows|g*x^| per column; "
                    "two runs bitwise equal",
    "rope_fwd": "rel*|x| (the same roundings: expected bitwise)",
    "rope_bwd": "rel*|x| (the same roundings: expected bitwise)",
    "rel": "2^-7 for bf16, 2^-10 for fp16, 1e-5 for fp32",
}


def norm_rope_case(dev, gen, lead, h: int, heads: int, d: int, dtype, label: str, card: dict,
                   timed: bool = False) -> dict:
    """Kernels 7-10 against their plain versions on the same inputs: the
    RMSNorm forward and backward of ``x [*lead, h]`` and the rope forward
    and adjoint of ``[*lead, heads, d]`` (``lead`` is ``[B, S]``) with the
    model's rope tables for positions ``0..S-1``. Fails on a miss."""
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.kernels import fused as kf
    from paddle_tpu_torch.models.llama import LlamaRotaryEmbedding

    rel = {torch.bfloat16: BF16_REL, torch.float16: 2.0 ** -10}.get(dtype, 1e-5)
    eps = 1e-5
    x = torch.randn((*lead, h), generator=gen, device=dev).to(dtype)
    g = torch.randn((*lead, h), generator=gen, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn((h,), generator=gen, device=dev)).to(dtype)
    y, rstd = kf.rms_norm_fwd(x, w, eps)
    y_p, rstd_p = kf.rms_norm_fwd_plain(x, w, eps)
    dx, dw = kf.rms_norm_bwd(x, w, rstd, g)
    dx2, dw2 = kf.rms_norm_bwd(x, w, rstd, g)
    dx_p, dw_p = kf.rms_norm_bwd_plain(x, w, rstd, g)
    xhat = x.float() * rstd[..., None]
    dw_scale = (g.float() * xhat).abs().reshape(-1, h).sum(0)
    del xhat
    torch.cuda.synchronize()
    checks, err = {}, {}
    err["y"], checks["y"] = within(y, y_p, atol=0.0, rel=rel)
    err["rstd"] = float(((rstd - rstd_p).abs() / rstd_p.abs()).max())
    checks["rstd"] = err["rstd"] <= 1e-5
    err["dx"], checks["dx"] = within(dx, dx_p, atol=1e-5 * float(dx_p.float().abs().max()), rel=rel)
    d_dw = (dw.float() - dw_p.float()).abs()
    err["dw"] = float(d_dw.max())
    checks["dw"] = bool((d_dw <= rel * torch.maximum(dw.float().abs(), dw_p.float().abs()) + 1e-5 * dw_scale).all())
    checks["bwd_deterministic"] = bool(torch.equal(dx, dx2)) and bool(torch.equal(dw, dw2))

    b, s = lead
    rope = LlamaRotaryEmbedding(d, max(s, 4096), 10000.0, dev)
    cos, sin = rope(s)
    q = torch.randn((b, s, heads, d), generator=gen, device=dev).to(dtype)
    gq = torch.randn((b, s, heads, d), generator=gen, device=dev).to(dtype)
    yq, yq_p = kf.rope_fwd(q, cos, sin), kf.rope_fwd_plain(q, cos, sin)
    dq, dq_p = kf.rope_bwd(gq, cos, sin), kf.rope_bwd_plain(gq, cos, sin)
    torch.cuda.synchronize()
    err["rope"], checks["rope"] = within(yq, yq_p, atol=0.0, rel=rel)
    err["rope_adjoint"], checks["rope_adjoint"] = within(dq, dq_p, atol=0.0, rel=rel)
    bitwise = {"rope": bool(torch.equal(yq, yq_p)), "rope_adjoint": bool(torch.equal(dq, dq_p))}
    plan = kf.rms_fwd_plan(h, dtype)
    line = {"phase": "kernel_check", "kernel": "rms_norm_fwd/rms_norm_bwd/rope_fwd/rope_bwd", "case": label,
            "norm_shape": [*lead, h], "rope_shape": [b, s, heads, d], "dtype": str(dtype).split(".")[-1],
            "rms_fwd_plan": plan, "max_err": err, "checks": checks, "rope_bitwise": bitwise,
            "tolerance": NORM_ROPE_TOL}
    if not all(checks.values()):
        emit({**line, "card": card})
        fail(f"kernels 7-10 disagree with their plain versions ({label}): {checks} {err}")
    res = {"max_abs_err": {"rms_norm_fwd": err["y"], "rms_norm_bwd": err["dx"], "rope_fwd": err["rope"],
                           "rope_bwd": err["rope_adjoint"]}, "dw_max_abs_err": err["dw"], "route": plan["route"]}
    if timed:
        rows, esz = x.numel() // h, x.element_size()
        qn = q.numel()
        tables = 2 * cos.numel() * 4
        # yardsticks only (the port never calls them): PyTorch's rms_norm
        # forward, and its autograd backward (dx and dw together)
        xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
        lib_out = tF.rms_norm(xr, (h,), wr, eps) if hasattr(tF, "rms_norm") else None
        runs = {
            "rms_norm_fwd": (lambda: kf.rms_norm_fwd(x, w, eps), lambda: kf.rms_norm_fwd_plain(x, w, eps),
                             None if lib_out is None else (lambda: tF.rms_norm(x, (h,), w, eps)),
                             bound(2 * rows * h * esz + h * esz + rows * 4, 4 * rows * h, FP32_FLOP_PER_S)),
            "rms_norm_bwd": (lambda: kf.rms_norm_bwd(x, w, rstd, g), lambda: kf.rms_norm_bwd_plain(x, w, rstd, g),
                             None if lib_out is None else
                             (lambda: torch.autograd.grad(lib_out, (xr, wr), g, retain_graph=True)),
                             bound(3 * rows * h * esz + 2 * h * esz + rows * 4, 10 * rows * h, FP32_FLOP_PER_S)),
            "rope_fwd": (lambda: kf.rope_fwd(q, cos, sin), lambda: kf.rope_fwd_plain(q, cos, sin), None,
                         bound(2 * qn * esz + tables, 3 * qn, FP32_FLOP_PER_S)),
            "rope_bwd": (lambda: kf.rope_bwd(gq, cos, sin), lambda: kf.rope_bwd_plain(gq, cos, sin), None,
                         bound(2 * qn * esz + tables, 3 * qn, FP32_FLOP_PER_S)),
        }
        times = {}
        for name, (run, run_plain, run_lib, bnd) in runs.items():
            times[name] = dict(ms=device_ms(run), call_ms=call_ms(run), plain_ms=device_ms(run_plain, iters=5),
                               plain_call_ms=call_ms(run_plain, iters=5),
                               library_ms=None if run_lib is None else device_ms(run_lib), **bnd)
        res["times"] = times
        line["times"] = times
        line["library"] = ("torch.nn.functional.rms_norm forward; its autograd backward (dx and dw); "
                           "no single PyTorch call for the rope")
        del lib_out, xr, wr
    emit({**line, "card": card})
    return res


RMS_FWD_GATE = 1.0  # kernel 7 at most this times F.rms_norm at the train shape [8192, 4096] bf16, in the same call


def rms_fwd_rows_times(dev, gen, card: dict) -> dict:
    """Kernel 7 at the unfused serve step's row counts (8 decode rows, 512
    rows of a mixed step) x 4096, bf16: device ms beside its bound, the
    plain version and ``F.rms_norm``, with the plan each took; and at the
    train shape ``[8192, 4096]`` with each split of the register route (1,
    2 and 4 warps a row: 16, 8 and 4 vectors a lane; the plan takes 4).
    Every run's y and rstd are held against the plain version first (y
    within ``BF16_REL`` x |y|, rstd within 1e-5 relative)."""
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels import fused as kf

    def agree(y, rstd, y_p, rstd_p, what: str) -> dict:
        torch.cuda.synchronize()
        err, ok = within(y, y_p, 0.0, BF16_REL)
        rstd_err = float(((rstd - rstd_p).abs() / rstd_p.abs()).max())
        if not ok or rstd_err > 1e-5:
            fail(f"rms_norm_fwd disagrees with its plain version {what} (y max abs err {err}, "
                 f"rstd max rel err {rstd_err})")
        return {"max_abs_err": err, "rstd_max_rel_err": rstd_err}

    x = torch.randn((8192, 4096), generator=gen, device=dev).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn((4096,), generator=gen, device=dev)).to(torch.bfloat16)
    y, rstd = torch.empty_like(x), torch.empty(8192, device=dev)
    y_p, rstd_p = kf.rms_norm_fwd_plain(x, w, 1e-5)
    fn = build.kernel_fn("ptt_rms_norm_fwd", [kf._I, kf._P, kf._P, kf._P, kf._P] + [kf._I] * 4 + [kf._F, kf._P])

    def split(vecs: int, warps: int) -> None:
        build.check(fn(1, x.data_ptr(), w.data_ptr(), y.data_ptr(), rstd.data_ptr(), 8192, 4096, vecs, warps, 1e-5,
                       torch.cuda.current_stream().cuda_stream), "rms_norm_fwd")

    out = {"train_shape_ms_by_warps_per_row": {}, "train_shape_err_by_warps_per_row": {}}
    for warps, vecs in ((1, 16), (2, 8), (4, 4)):  # each split held against the plain version, then timed
        y.fill_(float("nan"))
        rstd.fill_(float("nan"))
        split(vecs, warps)
        out["train_shape_err_by_warps_per_row"][warps] = agree(y, rstd, y_p, rstd_p,
                                                               f"at [8192, 4096], {warps} warps a row")
        out["train_shape_ms_by_warps_per_row"][warps] = device_ms(lambda v=vecs, wr=warps: split(v, wr))
    del x, w, y, rstd, y_p, rstd_p
    for rows in (8, 512):
        x = torch.randn((rows, 4096), generator=gen, device=dev).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn((4096,), generator=gen, device=dev)).to(torch.bfloat16)
        checked = agree(*kf.rms_norm_fwd(x, w, 1e-5), *kf.rms_norm_fwd_plain(x, w, 1e-5), f"at {rows} rows")
        out[f"rows_{rows}"] = dict(
            plan=kf.rms_fwd_plan(4096, torch.bfloat16), **checked,
            ms=device_ms(lambda: kf.rms_norm_fwd(x, w, 1e-5)), plain_ms=device_ms(lambda: kf.rms_norm_fwd_plain(x, w, 1e-5)),
            library_ms=device_ms(lambda: tF.rms_norm(x, (4096,), w, 1e-5)),
            **bound(2 * rows * 4096 * 2 + 4096 * 2 + rows * 4, 4 * rows * 4096, FP32_FLOP_PER_S))
    emit({"phase": "rms_norm_fwd_rows", "h": 4096, "dtype": "bfloat16", **out, "card": card})
    return out


def check_norm_rope(dev, gen, card: dict, records: dict) -> None:
    """Kernels 7-10 at the train shapes (norm ``[2, 4096, 4096]``, rope
    ``[2, 4096, 32, 128]``, bf16; timed), at a ragged bf16 shape (a 3-row
    batch of 1001 positions, H 5120, 8 heads), at ragged fp32 and fp16
    ones (H 384: fp16's takes kernel 7's loop route, fp32's the register
    route; both routes must have run) and at the ``wide_heads`` phase's
    train shapes (norm ``[2, 4096, 2560]``, 2 warps a row, with rope
    ``[2, 4096, 8, 320]``; norm ``[2, 4096, 4096]`` with rope ``[2, 4096,
    8, 512]``). Kernel 7 is gated at
    :data:`RMS_FWD_GATE` x ``F.rms_norm`` at the train shape and timed at
    the unfused serve's row counts (:func:`rms_fwd_rows_times`)."""
    import torch
    from paddle_tpu_torch.kernels import fused as kf

    bf = torch.bfloat16
    train = norm_rope_case(dev, gen, (2, 4096), 4096, 32, 128, bf, "train shapes", card, timed=True)
    routes = {train["route"]}
    routes.add(norm_rope_case(dev, gen, (3, 1001), 5120, 8, 128, bf, "ragged rows, H 5120, 8 heads", card)["route"])
    routes.add(norm_rope_case(dev, gen, (3, 77), 384, 5, 256, torch.float32, "fp32, ragged rows, D 256", card)["route"])
    routes.add(norm_rope_case(dev, gen, (3, 77), 384, 5, 256, torch.float16, "fp16, ragged rows, D 256", card)["route"])
    # the wide_heads phase's shapes: H 2560 is the register route at 2 warps a row (5 vectors a lane), and the
    # rope at its head dims 320 and 512
    if kf.rms_fwd_plan(2560, bf)["warps_per_row"] != 2:
        fail(f"kernel 7's plan at H 2560 bf16 is {kf.rms_fwd_plan(2560, bf)}, not 2 warps a row")
    norm_rope_case(dev, gen, (2, 4096), 2560, 8, 320, bf, "wide_heads d320: H 2560, 8 heads of 320", card)
    norm_rope_case(dev, gen, (2, 4096), 4096, 8, 512, bf, "wide_heads d512: H 4096, 8 heads of 512", card)
    if routes != {"regs", "loop"}:
        fail(f"kernel 7's checks ran the routes {sorted(routes)}, not both of regs and loop")
    for name, src in NORM_ROPE_SOURCES.items():
        t = train["times"][name]
        records[name] = dict(source=src, max_abs_err=train["max_abs_err"][name], **t)
    records["rms_norm_bwd"]["dw_max_abs_err"] = train["dw_max_abs_err"]
    fwd = records["rms_norm_fwd"]
    fwd.update(rms_fwd_rows_times(dev, gen, card))
    ratio = fwd["ms"] / fwd["library_ms"]
    emit({"phase": "rms_norm_fwd_gate", "shape": [8192, 4096], "dtype": "bfloat16", "ms": fwd["ms"],
          "library_ms": fwd["library_ms"], "ratio": ratio, "share_of_bound": fwd["bound_ms"] / fwd["ms"],
          "gate": f"ms <= {RMS_FWD_GATE} x F.rms_norm", "card": card})
    if ratio > RMS_FWD_GATE:
        fail(f"rms_norm_fwd takes {fwd['ms']:.5f} ms at [8192, 4096] bf16, {ratio:.3f}x F.rms_norm's "
             f"{fwd['library_ms']:.5f} (gate {RMS_FWD_GATE}x)")
    torch.cuda.empty_cache()


# -- kernels 11-13: the residual norms' adjoints and the residual LayerNorm ------

RESIDUAL_NORM_SOURCES = {
    "rms_residual_bwd": "paddle_tpu_torch/kernels/csrc/rms_norm.cu",
    "ln_residual": "paddle_tpu_torch/kernels/csrc/ln_residual.cu",
    "ln_residual_bwd": "paddle_tpu_torch/kernels/csrc/ln_residual.cu",
}
# rel is one ulp of the I/O type as for kernels 7-10. y and dx add 1e-5 of
# their largest value: y = (r - mean) rstd w + b and dx = rstd (g w -
# mean(g w) - x^ mean(g w x^)) cancel to near 0 where the terms do not, and
# both versions' fp32 statistics are sums in other orders. dw and db add
# 1e-5 of each column's sum of |g x^| resp. |g| (a reordered fp32 sum).
LN_BWD_SHARE_GATE = 0.5  # kernel 13 at [8192, 5120] bf16: at least this share of its bound, cold L2
LN_BWD_LIBRARY_GATE = 1.0  # and at most this times the autograd backward of F.layer_norm, in the same call
RESIDUAL_NORM_TOL = {
    "ln_residual": "r bitwise; y: rel*max(|got|, |ref|) + 1e-5*max|y|",
    "ln_residual_bwd": "dx: rel*|x| + 1e-5*max|dx|; dw, db: rel*|x| + 1e-5*sum_rows|g*x^| resp. |g| per column; "
                       "two runs bitwise equal",
    "rms_residual_bwd": "as ln_residual_bwd's dx and dw",
    "rel": "2^-7 for bf16, 2^-10 for fp16, 1e-5 for fp32",
}


def column_gate(got, want, rel: float, scale) -> tuple:
    """(max abs error, ok) of a weight or bias gradient: per column within
    ``rel * max(|got|, |want|) + 1e-5 * scale``."""
    import torch

    d = (got.float() - want.float()).abs()
    lim = rel * torch.maximum(got.float().abs(), want.float().abs()) + 1e-5 * scale
    return float(d.max()), bool((d <= lim).all())


def residual_norm_case(dev, gen, lead, h: int, dtype, label: str, card: dict, timed: bool = False,
                       which=("ln", "rms")) -> dict:
    """Kernels 12 and 13 (``"ln"``) and 11 (``"rms"``) against their plain
    versions on the same inputs, ``[*lead, h]``; with ``timed`` their
    times. Fails on a miss."""
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.kernels import fused as kf

    rel = {torch.bfloat16: BF16_REL, torch.float16: 2.0 ** -10}.get(dtype, 1e-5)
    eps = 1e-5
    x = torch.randn((*lead, h), generator=gen, device=dev).to(dtype)
    res = (2 * torch.randn((*lead, h), generator=gen, device=dev)).to(dtype)
    g = torch.randn((*lead, h), generator=gen, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn((h,), generator=gen, device=dev)).to(dtype)
    b = (0.1 * torch.randn((h,), generator=gen, device=dev)).to(dtype)
    rows, esz = x.numel() // h, x.element_size()
    checks, err, res_out, runs = {}, {}, {"max_abs_err": {}}, {}
    if "ln" in which:
        (y, r), (y_p, r_p) = kf.ln_residual(x, w, b, res, eps), kf.ln_residual_plain(x, w, b, res, eps)
        dx, dw, db = kf.ln_residual_bwd(g, r, w, eps)
        dx2, dw2, db2 = kf.ln_residual_bwd(g, r, w, eps)
        dx_p, dw_p, db_p = kf.ln_residual_bwd_plain(g, r, w, eps)
        rf = r.float()
        xhat = (rf - rf.mean(-1, keepdim=True)) * torch.rsqrt((rf - rf.mean(-1, keepdim=True)).square().mean(-1, keepdim=True) + eps)
        dw_scale = (g.float() * xhat).abs().reshape(-1, h).sum(0)
        db_scale = g.float().abs().reshape(-1, h).sum(0)
        del rf, xhat
        torch.cuda.synchronize()
        checks["r"] = bool(torch.equal(r, r_p))
        err["y"], checks["y"] = within(y, y_p, atol=1e-5 * float(y_p.float().abs().max()), rel=rel)
        err["ln_dx"], checks["ln_dx"] = within(dx, dx_p, atol=1e-5 * float(dx_p.float().abs().max()), rel=rel)
        err["ln_dw"], checks["ln_dw"] = column_gate(dw, dw_p, rel, dw_scale)
        err["ln_db"], checks["ln_db"] = column_gate(db, db_p, rel, db_scale)
        checks["ln_bwd_deterministic"] = all(bool(torch.equal(a, c)) for a, c in ((dx, dx2), (dw, dw2), (db, db2)))
        res_out["max_abs_err"].update(ln_residual=err["y"], ln_residual_bwd=err["ln_dx"])
        res_out["ln_residual_bwd_dw_db_max_abs_err"] = [err["ln_dw"], err["ln_db"]]
        del y, y_p, r_p, dx2, dw2, db2, dx_p
        if timed:
            # yardstick only (the port never calls it): PyTorch's layer_norm
            # backward (dx, dw, db) through autograd; no single PyTorch call
            # adds the residual and normalises
            rr, wr, br = r.detach().requires_grad_(), w.detach().requires_grad_(), b.detach().requires_grad_()
            lib_out = tF.layer_norm(rr, (h,), wr, br, eps)
            runs["ln_residual"] = (lambda: kf.ln_residual(x, w, b, res, eps),
                                   lambda: kf.ln_residual_plain(x, w, b, res, eps), None,
                                   bound(4 * rows * h * esz + 2 * h * esz, 8 * rows * h, FP32_FLOP_PER_S))
            runs["ln_residual_bwd"] = (lambda: kf.ln_residual_bwd(g, r, w, eps),
                                       lambda: kf.ln_residual_bwd_plain(g, r, w, eps),
                                       lambda: torch.autograd.grad(lib_out, (rr, wr, br), g, retain_graph=True),
                                       bound(3 * rows * h * esz + 3 * h * esz, 14 * rows * h, FP32_FLOP_PER_S))
    if "rms" in which:
        rs = x + res
        dx, dw = kf.rms_residual_bwd(g, rs, w, eps)
        dx2, dw2 = kf.rms_residual_bwd(g, rs, w, eps)
        dx_p, dw_p = kf.rms_residual_bwd_plain(g, rs, w, eps)
        rf = rs.float()
        dw_scale = (g.float() * rf * torch.rsqrt(rf.square().mean(-1, keepdim=True) + eps)).abs().reshape(-1, h).sum(0)
        del rf
        torch.cuda.synchronize()
        err["rms_dx"], checks["rms_dx"] = within(dx, dx_p, atol=1e-5 * float(dx_p.float().abs().max()), rel=rel)
        err["rms_dw"], checks["rms_dw"] = column_gate(dw, dw_p, rel, dw_scale)
        checks["rms_bwd_deterministic"] = bool(torch.equal(dx, dx2)) and bool(torch.equal(dw, dw2))
        res_out["max_abs_err"]["rms_residual_bwd"] = err["rms_dx"]
        res_out["rms_residual_bwd_dw_max_abs_err"] = err["rms_dw"]
        del dx2, dw2, dx_p
        if timed:
            # yardstick only: PyTorch's rms_norm backward (dx, dw) through autograd, as for kernel 8
            rs_leaf, w_leaf = rs.detach().requires_grad_(), w.detach().requires_grad_()
            rms_out = tF.rms_norm(rs_leaf, (h,), w_leaf, eps) if hasattr(tF, "rms_norm") else None
            runs["rms_residual_bwd"] = (lambda: kf.rms_residual_bwd(g, rs, w, eps),
                                        lambda: kf.rms_residual_bwd_plain(g, rs, w, eps),
                                        None if rms_out is None else
                                        (lambda: torch.autograd.grad(rms_out, (rs_leaf, w_leaf), g, retain_graph=True)),
                                        bound(3 * rows * h * esz + 2 * h * esz, 10 * rows * h, FP32_FLOP_PER_S))
    line = {"phase": "kernel_check", "kernel": "/".join(k for k in RESIDUAL_NORM_SOURCES
                                                     if k.startswith(tuple(which))),
            "case": label, "shape": [*lead, h], "dtype": str(dtype).split(".")[-1], "max_err": err,
            "checks": checks, "tolerance": RESIDUAL_NORM_TOL}
    if not all(checks.values()):
        emit({**line, "card": card})
        fail(f"kernels 11-13 disagree with their plain versions ({label}): {checks} {err}")
    if timed:
        times = {}
        for name, (run, run_plain, run_lib, bnd) in runs.items():
            times[name] = dict(ms=device_ms(run), call_ms=call_ms(run), plain_ms=device_ms(run_plain, iters=5),
                               plain_call_ms=call_ms(run_plain, iters=5),
                               library_ms=None if run_lib is None else device_ms(run_lib), **bnd)
        if "ln_residual_bwd" in times:
            # kernel 13's loop route (the shared-memory design it had before its register route) on the same
            # inputs in the same call, beside the plan's route
            plan = kf.ln_bwd_plan(h, dtype)
            real = kf.ln_bwd_plan
            kf.ln_bwd_plan = lambda *_: {"route": "loop", "vecs": 0, "warps_per_row": 8}
            try:
                loop_ms = device_ms(runs["ln_residual_bwd"][0])
            finally:
                kf.ln_bwd_plan = real
            times["ln_residual_bwd"].update(plan=plan, loop_route_ms=loop_ms,
                                            share_of_bound=times["ln_residual_bwd"]["bound_ms"] / times["ln_residual_bwd"]["ms"])
        res_out["times"] = line["times"] = times
        line["library"] = ("ln_residual: none (no single PyTorch call adds and normalises); ln_residual_bwd: "
                           "autograd backward of torch.nn.functional.layer_norm (dx, dw, db); rms_residual_bwd: "
                           "autograd backward of torch.nn.functional.rms_norm (dx, dw)")
    emit({**line, "card": card})
    runs.clear()
    torch.cuda.empty_cache()
    return res_out


def check_residual_norms(dev, gen, card: dict, records: dict) -> None:
    """Kernels 12 and 13 at the GPT-3 13B train shape ``[4, 2048, 5120]``
    and kernel 11 at the Llama-2-7B one ``[2, 4096, 4096]``, bf16 and
    timed, kernel 13 gated at :data:`LN_BWD_SHARE_GATE` of its bound and
    :data:`LN_BWD_LIBRARY_GATE` x the library (its loop route timed beside
    it); all three at ragged rows in fp16 and fp32, and kernels 12 and 13
    at ragged rows on each shape of kernel 13's register route that the
    widths of GPT-3 13B, 2.7B and 175B take (``ln_bwd_plan``)."""
    import torch
    from paddle_tpu_torch.kernels import fused as kf

    bf = torch.bfloat16
    ln = residual_norm_case(dev, gen, (4, 2048), 5120, bf, "GPT-3 13B train shape", card, timed=True, which=("ln",))
    rms = residual_norm_case(dev, gen, (2, 4096), 4096, bf, "Llama-2-7B train shape", card, timed=True,
                             which=("rms",))
    for dtype in (torch.float16, torch.float32):
        residual_norm_case(dev, gen, (3, 77), 384, dtype, f"{str(dtype).split('.')[-1]}, ragged rows", card)
    for h, dtype in ((5120, bf), (2560, torch.float16), (5120, torch.float32), (12288, bf)):
        plan = kf.ln_bwd_plan(h, dtype)
        residual_norm_case(dev, gen, (3, 77), h, dtype, f"{str(dtype).split('.')[-1]}, ragged rows, H {h}: "
                           f"{plan['route']} {plan['warps_per_row']} warps x {plan['vecs']} vectors", card,
                           which=("ln",))
    t = ln["times"]["ln_residual_bwd"]
    ratio = t["ms"] / t["library_ms"]
    emit({"phase": "ln_residual_bwd_gate", "shape": [8192, 5120], "dtype": "bfloat16", "plan": t["plan"],
          "ms": t["ms"], "loop_route_ms": t["loop_route_ms"], "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
          "share_of_bound": t["share_of_bound"], "ms_over_library": ratio,
          "gate": {"share_of_bound_at_least": LN_BWD_SHARE_GATE, "ms_over_library_at_most": LN_BWD_LIBRARY_GATE},
          "card": card})
    if t["share_of_bound"] < LN_BWD_SHARE_GATE or ratio > LN_BWD_LIBRARY_GATE:
        fail(f"ln_residual_bwd at [8192, 5120] bf16: {t['share_of_bound']:.3f} of its bound, {ratio:.3f}x the "
             f"library; the gates are {LN_BWD_SHARE_GATE} and {LN_BWD_LIBRARY_GATE}x")
    for name, src in RESIDUAL_NORM_SOURCES.items():
        rec = ln if name.startswith("ln") else rms
        records[name] = dict(source=src, max_abs_err=rec["max_abs_err"][name], **rec["times"][name])


def check_residual_repair(dev, gen, card: dict) -> dict:
    """The repaired ``fused_rms_norm_residual`` on the card: with inputs that
    need gradients its outputs carry ``ResidualNormFunction``'s node, and
    the x, residual and weight gradients through kernels C and 11 equal the
    plain versions' (kernel 11's dx gate; dw per column). The launch
    counters are reset just before and read just after: C once, 11 once.
    Returns the counts."""
    import torch
    from paddle_tpu_torch.incubate.nn.functional import fused_rms_norm_residual
    from paddle_tpu_torch.kernels import fused as kf
    from paddle_tpu_torch.kernels.select import launch_counts, reset_launch_counts

    lead, h, eps = (2, 1024), 4096, 1e-5
    x, res, g, gr = (torch.randn((*lead, h), generator=gen, device=dev).to(torch.bfloat16) for _ in range(4))
    w = (1 + 0.1 * torch.randn((h,), generator=gen, device=dev)).to(torch.bfloat16)
    leaves = [t.detach().requires_grad_() for t in (x, w, res)]
    torch.cuda.synchronize()
    reset_launch_counts()
    y, r = fused_rms_norm_residual(*leaves, eps)
    torch.autograd.backward([y, r], [g, gr])
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    node = type(y.grad_fn).__name__
    y_p, r_p = kf.fused_rms_norm_residual_plain(x, w, res, eps)
    dx_p, dw_p = kf.rms_residual_bwd_plain(g, r_p, w, eps)
    dr_p = dx_p + gr
    rf = r_p.float()
    dw_scale = (g.float() * rf * torch.rsqrt(rf.square().mean(-1, keepdim=True) + eps)).abs().reshape(-1, h).sum(0)
    err, checks = {}, {"grad_fn": node == "ResidualNormFunctionBackward",
                       "launches": counts == {"rms_residual": 1, "rms_residual_bwd": 1},
                       "r": bool(torch.equal(r, r_p))}
    err["y"], checks["y"] = within(y.detach(), y_p, atol=0.0, rel=BF16_REL)
    # kernel 11's dx gate (one ulp of the adjoint, 1e-5 of its largest
    # value) carried through the add of the residual stream's cotangent,
    # plus one ulp of the sum's own rounding
    lim = (BF16_REL * dx_p.float().abs() + 1e-5 * float(dx_p.float().abs().max())).reshape(-1)
    for name, leaf in (("x", leaves[0]), ("residual", leaves[2])):
        got, want = leaf.grad.float().reshape(-1), dr_p.float().reshape(-1)
        d = (got - want).abs()
        err[name] = float(d.max())
        checks[name] = bool((d <= lim + BF16_REL * torch.maximum(got.abs(), want.abs())).all())
    err["weight"], checks["weight"] = column_gate(leaves[1].grad, dw_p, BF16_REL, dw_scale)
    emit({"phase": "residual_repair", "entry": "incubate fused_rms_norm_residual", "shape": [*lead, h],
          "dtype": "bfloat16", "grad_fn": node, "launches": counts, "max_abs_err": err, "checks": checks,
          "tolerance": "x, residual against d_r = dx + the residual stream's cotangent, dx from "
                       "rms_residual_bwd_plain: rel*|dx| + 1e-5*max|dx| + rel*max(|got|, |ref|); weight: "
                       "rel*|x| + 1e-5*sum_rows|g*x^| per column (rel 2^-7); r bitwise",
          "card": card})
    if not all(checks.values()):
        fail(f"fused_rms_norm_residual's gradients on the card: {checks} {err} (launched {counts})")
    return counts


# -- kernels 17-19: fused linear cross entropy forward, dX, dW ------------------

FLXENT_SOURCES = {  # the train shape's instances (bf16, W [H, V]: the wgmma route)
    "flxent_fwd": "paddle_tpu_torch/kernels/csrc/flxent_wgmma.cu",
    "flxent_dchunk": "paddle_tpu_torch/kernels/csrc/flxent_wgmma.cu",
    "flxent_dx": "paddle_tpu_torch/kernels/csrc/flxent_wgmma.cu",
    "flxent_dw": "paddle_tpu_torch/kernels/csrc/flxent_wgmma.cu",
}
# lse, tl: fp32 sums of H products in another order; at |logit| ~ 1 and H
# 4096 a reordering moves them by ~sqrt(H) * 2^-24 ~ 4e-6, held at 1e-4 of
# max(1, |v|). D: both versions round fp32 values that agree to a few fp32
# ulps to the I/O type, so an element may land on the other neighbour: one
# spacing of the type at that value, at most ulp * |D| (ulp 2^-7 in bf16,
# 2^-10 in fp16) and, below the smallest normal, the subnormal spacing
# sub = tiny * ulp (2^-24 in fp16, where D ~ gcoef / V is subnormal; ~1e-40
# in bf16). dX, dW: a sum of D terms, each of which may be one spacing
# apart, so per element ulp * (|D| |W|^T) + sub * sum_v |W| for dX and
# ulp * (|x|^T |D|) + sub * sum_n |x| for dW (the plain version run on
# absolute values), plus the rounding of each side's fp32 sum to the I/O
# type, ulp * max(|got|, |ref|) + sub; and over the whole tensor a
# relative L2 error of at most half an ulp. fp32 (the CUDA-core instance
# against the plain version with TF32 off): nothing is rounded to a narrower
# type, and both sides sum the same H fp32 products in other orders (the
# kernel in k tiles of 16). The rounding errors of such a sum add like a
# random walk, about 2^-24 sqrt(H) q (q = sqrt(x^2 (W_c^2)^T), the l2 norm
# of a logit's products); D = p g - onehot g moves by |D| times its logit's
# error. The gate allows 16 times that, 2^-16 (sqrt(H) / 16) q, so: the
# same gates with ulp 2^-16, |D| scaled by 1 + sqrt(H) / 16 q wherever it
# appears (fp32_logit_scale), and sub 0. TF32 rounds the operands to 10 bits
# and moves a logit by about 2^-11 q: every fp32 case reads the plain D with
# TF32 on under the same gate, and fails unless the gate rejects it.
FLXENT_ULP = {"bfloat16": BF16_REL, "float16": 2.0 ** -10, "float32": 2.0 ** -16}
# Kernel 17 in fp32 (lse, tl): its logits move as D's do, by up to 2^-16
# sqrt(H) / 16 q each (the random walk of the fp32 rounding errors of two
# sums of H products in other orders, 16 times over), and lse by the
# probability-weighted sum of its logits' moves; plus 2^-16 of the value for
# its own rounding. One TF32 pass moves a logit by about 2^-11 q: the plain
# forward with TF32 on must fail this gate.
FLX_FWD_FP32_TOL = ("per row |lse - ref| <= 2^-16 (max(|lse|, |ref|) + sqrt(H) / 16 * sum_v p_v q_v), |tl - ref| <= "
                    "2^-16 (max(|tl|, |ref|) + sqrt(H) / 16 * q at the label); q = sqrt(x^2 (W_c^2)^T) (times |scale| "
                    "of the column for an int8 W), p = exp(logit - lse); the plain forward with TF32 on must fail it")
FLXENT_TOL = {"lse, tl": "1e-4 * max(1, |v|) in bf16 / fp16; fp32: " + FLX_FWD_FP32_TOL,
              "D": "per element ulp * max(|got|, |ref|) + sub (fp32: times 1 + sqrt(H) / 16 * "
                   "sqrt(x^2 (W_c^2)^T), and the plain D with TF32 on must fail this gate)",
              "dx, dw": "per element ulp * (|D| |W|^T resp. |x|^T |D|) + sub * (sum_v |W| resp. sum_n |x|) "
                        "+ ulp * max(|got|, |ref|) + sub; rel L2 <= ulp/2 "
                        "(ulp 2^-7 bf16, 2^-10 fp16, 2^-16 fp32; sub = tiny * ulp, the subnormal spacing, "
                        "0 in fp32; in fp32 |D| times 1 + sqrt(H) / 16 * sqrt(x^2 (W_c^2)^T))",
              "repeat": "two flxent_fwd and two flxent_bwd calls give the same bits",
              "route": "each case states the route kernel 17 and the backward (flx_route_of) must take for its "
                       "tensors"}
FLXENT_TF32_SOURCE = "paddle_tpu_torch/kernels/csrc/flxent_tf32.cu"  # the fp32 backward's 3xTF32 instance
FLX_GATE = 1.25  # kernels 18 and 19 each at most this times the library's whole backward at the train shape
FLX_FP32_GATE = 1.0  # 18 and 19 fp32 (3xTF32) each at most this times the library's fp32 backward, x [2048, 4096]
FLX_FWD_GATE = 1.0  # kernel 17 at most this times the library's forward (x @ W + F.cross_entropy) at the train shape
FLX_FP32_FWD_GATE = 1.0  # 17 fp32 (3xTF32) at most this times the library's fp32 forward at x [2048 / 8192, 4096]
FLX_INT8_GATE = 1.25  # kernel 17's int8 site at most this times its library at the train shape
FLX_INT8_FP32_GATE = 1.0  # its fp32 instance (2xTF32) at most this times its fp32 library at x [2048, 4096]
FLX_WIDEN_GATE = 1.0  # its widen pass at most this times PyTorch's one call for the same plane, in both layouts


def flxent_inputs(dev, gen, n: int, h: int, v: int, dtype, vocab_major: bool, w_offset: int = 0):
    """x ~ N(0, 1) (a normed hidden), W ~ N(0, 0.02) (the model's init) in
    the given layout (contiguous, ``w_offset`` elements into its storage),
    labels in [0, V) with every tenth row ignored (-100) and two rows past
    V, and the gcoef of a mean over the valid rows."""
    import torch

    x = torch.randn((n, h), generator=gen, device=dev).to(dtype)
    w = (0.02 * torch.randn((v, h) if vocab_major else (h, v), generator=gen, device=dev)).to(dtype)
    if w_offset:
        w = torch.cat([torch.zeros(w_offset, dtype=dtype, device=dev), w.reshape(-1)])[w_offset:].view(w.shape)
    lab = torch.randint(0, v, (n,), generator=gen, device=dev, dtype=torch.int32)
    lab[::10] = -100
    lab[1], lab[n // 2 + 1] = v, v + 12345
    valid = lab != -100
    gcoef = torch.where(valid, 1.0 / valid.sum().float(), 0.0).contiguous()
    return x, w, lab, gcoef


def flxent_abs_scales(x, w, lab, lse, gcoef, vocab_major: bool, ulp: float, sub: float):
    """The most that D's rounding can move dX and dW, in fp32 (the second
    in ``W``'s layout): the backward's products run on absolute values,
    with ``|D|`` from the plain version (in fp32 times
    :func:`fp32_logit_scale`), times ``ulp``, plus the subnormal spacing
    ``sub`` times the sums of ``|W|`` over the vocab and of ``|x|`` over the
    rows."""
    import torch
    from paddle_tpu_torch.kernels import fused_loss as kl

    n, h = x.shape
    v = w.shape[0] if vocab_major else w.shape[1]
    xa = x.float().abs()
    sx = torch.zeros((n, h), dtype=torch.float32, device=x.device)
    sw = torch.empty(w.shape, dtype=torch.float32, device=x.device)
    for c0 in range(0, v, kl.CHUNK):
        c1 = min(c0 + kl.CHUNK, v)
        da = kl.flxent_dchunk_plain(x, w, lab, lse, gcoef, c0, c1, vocab_major).float().abs()
        wa = (w[c0:c1] if vocab_major else w[:, c0:c1].t()).float().abs()  # [c1 - c0, H]
        if x.dtype == torch.float32:
            da *= fp32_logit_scale(x, wa)
        sx += da @ wa
        swc = da.t() @ xa  # [c1 - c0, H]
        if vocab_major:
            sw[c0:c1] = swc
        else:
            sw[:, c0:c1] = swc.t()
        del da, wa, swc
    w_sum = w.float().abs().sum(dim=0 if vocab_major else 1)  # [H]: sum_v |W[h, v]|
    x_sum = xa.sum(dim=0)  # [H]: sum_n |x[n, h]|
    sx = ulp * sx + sub * w_sum[None, :]
    sw = ulp * sw + sub * (x_sum[None, :] if vocab_major else x_sum[:, None])
    return sx, sw


def fp32_logit_scale(x, wc):
    """fp32 only: ``1 + sqrt(H) / 16 * sqrt(x^2 (W_c^2)^T)``, ``[N, Vc]`` for
    ``x [N, H]`` and the chunk's ``wc [Vc, H]``: in units of 2^-16, how far
    two fp32 sums of a logit's H products in other orders may move it
    (16 times the random walk of their rounding errors, 2^-24 sqrt(H) times
    the products' l2 norm), plus 1 for D's own rounding."""
    import torch

    x2 = x.float().square()
    return 1 + (x.shape[1] ** 0.5 / 16) * (x2 @ wc.float().square().t()).sqrt()


def fp32_fwd_scales(x, w, lab, lse, vocab_major: bool, scale=None):
    """fp32 only: per row, in units of 2^-16, how far two fp32 sums of the
    logits' H products in other orders may move ``lse`` and ``tl``: for each
    logit ``sqrt(H) / 16 * q`` (:func:`fp32_logit_scale` less D's own
    rounding; ``q = sqrt(x^2 (W_c^2)^T)``, times ``|scale|`` of its column for
    an int8 W), weighted by its probability ``exp(logit - lse)`` and summed
    for ``lse`` (``d lse = sum_v p_v d logit_v``), at the label's column for
    ``tl`` (0 where the label matches no column). Returns ``(s_lse, s_tl)``,
    fp32 ``[N]``, from the fp32 logits (TF32 off) in chunks of ``CHUNK``."""
    import torch
    from paddle_tpu_torch.kernels import fused_loss as kl

    n, h = x.shape
    v = w.shape[0] if vocab_major else w.shape[1]
    xf = x.float()
    x2 = xf.square()
    lab = lab.long()
    s_lse = torch.zeros((n,), dtype=torch.float32, device=x.device)
    s_tl = torch.zeros_like(s_lse)
    for c0 in range(0, v, kl.CHUNK):
        c1 = min(c0 + kl.CHUNK, v)
        wc = (w[c0:c1] if vocab_major else w[:, c0:c1].t()).float()  # [c1 - c0, H]
        q = (x2 @ wc.square().t()).sqrt()
        logits = xf @ wc.t()
        if scale is not None:
            q = q * scale[c0:c1].abs()[None, :]
            logits = logits * scale[c0:c1][None, :]
        s_lse += (torch.exp(logits - lse[:, None]) * q).sum(dim=1)
        hit = (lab >= c0) & (lab < c1)
        s_tl += torch.where(hit, q.gather(1, (lab - c0).clamp(0, c1 - c0 - 1)[:, None])[:, 0], 0.0)
        del q, logits, wc
    f = h ** 0.5 / 16
    return f * s_lse, f * s_tl


def fp32_fwd_gate(lse, tl, lse_ref, tl_ref, scales) -> dict:
    """The fp32 forward's gate (:data:`FLX_FWD_FP32_TOL`) on the logits' own
    scale: per row ``|lse - lse_ref| <= 2^-16 (max(|lse|, |lse_ref|) +
    s_lse)`` and likewise for ``tl`` with ``s_tl`` (``scales`` from
    :func:`fp32_fwd_scales`). Returns each one's :func:`gate_reading`."""
    import torch

    ulp = FLXENT_ULP["float32"]
    return {name: gate_reading(got, ref, ulp * (torch.maximum(got.abs(), ref.abs()) + s))
            for name, got, ref, s in (("lse", lse, lse_ref, scales[0]), ("tl", tl, tl_ref, scales[1]))}


def gate_reading(got, ref, limit) -> dict:
    """An element-wise gate's reading: whether every element is within its
    limit, the worst error over its limit, and the medians of |ref| and of
    the limit (a limit far above the values would let a wrong kernel pass)."""
    import torch

    g, r = got.float(), ref.float()
    ratio = float(((g - r).abs() / limit.clamp(min=1e-30)).max())
    # medians of an evenly strided sample of at most ~2^20 elements (integer strides: an fp32
    # linspace rounds indices past 2^24)
    idx = torch.arange(0, r.numel(), max(1, r.numel() >> 20), device=r.device)
    return {"ok": ratio <= 1.0, "worst_err_over_limit": ratio,
            "median_abs_ref": float(r.reshape(-1)[idx].abs().median()),
            "median_limit": float(limit.reshape(-1)[idx].median())}


def flxent_case(dev, gen, n, h, v, dtype, vocab_major, label: str, card: dict, route_want: str,
                timed: bool = False, w_offset: int = 0) -> dict:
    """Kernels 17-19 and the D recompute (first and last vocab chunk)
    against their plain versions on the same inputs, on the route
    ``flx_route_of`` names for kernel 17 and the backward alike, which must
    be ``route_want`` (printed); two ``flxent_fwd`` and two ``flxent_bwd`` calls must
    give the same bits. ``w_offset`` places W that
    many elements into its storage. In fp32 (run with TF32 off by the
    caller) kernel 17's lse and tl are held to :func:`fp32_fwd_gate` and
    the plain D with TF32 on must fail D's gate, the plain forward with
    TF32 on the forward's. With ``timed``
    their times, the plain versions', the unfused composition's (cuBLAS
    ``x @ W`` + ``F.cross_entropy``: two calls, forward and backward) and
    the loss head's peak memory fused and unfused."""
    import torch
    from paddle_tpu_torch.kernels import fused_loss as kl

    ulp = FLXENT_ULP[str(dtype).split(".")[-1]]
    sub = 0.0 if dtype == torch.float32 else torch.finfo(dtype).tiny * ulp  # the spacing of the type's subnormals
    x, w, lab, gcoef = flxent_inputs(dev, gen, n, h, v, dtype, vocab_major, w_offset)
    route = kl.flx_route_of(x, w, vocab_major)
    if route != route_want:
        fail(f"kernels 17-19 ({label}): the route is {route}, not {route_want}")
    lse, tl = kl.flxent_fwd(x, w, lab, vocab_major)
    lse2, tl2 = kl.flxent_fwd(x, w, lab, vocab_major)
    dx, dw = kl.flxent_bwd(x, w, lab, lse, gcoef, vocab_major)
    dx2, dw2 = kl.flxent_bwd(x, w, lab, lse, gcoef, vocab_major)
    dx_only, _ = kl.flxent_bwd(x, w, lab, lse, gcoef, vocab_major, need_dw=False)
    _, dw_only = kl.flxent_bwd(x, w, lab, lse, gcoef, vocab_major, need_dx=False)
    lse_p, tl_p = kl.flxent_fwd_plain(x, w, lab, vocab_major)
    # the backward versions from the same lse: the comparison is of the backward alone
    dx_p, dw_p = kl.flxent_bwd_plain(x, w, lab, lse, gcoef, vocab_major)
    torch.cuda.synchronize()
    err, checks, readings = {}, {}, {}
    for name, got, want in (("lse", lse, lse_p), ("tl", tl, tl_p)):
        d = (got - want).abs()
        err[name] = float(d.max())
        checks[name] = bool((d <= 1e-4 * want.abs().clamp(min=1.0)).all())
    if dtype == torch.float32:  # the fp32 forward's gate on the logits' own scale, and its TF32 control
        readings.update(fp32_fwd_readings(x, w, lab, lse, tl, lse_p, tl_p, vocab_major))
        checks.update({k: readings[k].pop("ok") for k in ("lse", "tl")})
        checks["the lse / tl gate rejects the TF32 forward"] = not readings["tf32 control"].pop("ok")
    last = (v - 1) // kl.CHUNK * kl.CHUNK
    err["d"] = 0.0
    for c0 in sorted({0, last}):
        c1 = min(c0 + kl.CHUNK, v)
        got = kl.flxent_dchunk(x, w, lab, lse, gcoef, c0, c1, vocab_major).float()
        want = kl.flxent_dchunk_plain(x, w, lab, lse, gcoef, c0, c1, vocab_major).float()
        scale = 1.0
        if dtype == torch.float32:
            scale = fp32_logit_scale(x, w[c0:c1] if vocab_major else w[:, c0:c1].t())
        limit = ulp * torch.maximum(got.abs(), want.abs()) * scale + sub
        readings[f"d[:, {c0}:{c1}]"] = r = gate_reading(got, want, limit)
        checks[f"d[:, {c0}:{c1}]"] = r.pop("ok")
        err["d"] = max(err["d"], float((got - want).abs().max()))
        if dtype == torch.float32:  # the control: D from TF32 logits, under the same gate
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                ctl = kl.flxent_dchunk_plain(x, w, lab, lse, gcoef, c0, c1, vocab_major).float()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
            r = gate_reading(ctl, want, ulp * torch.maximum(ctl.abs(), want.abs()) * scale + sub)
            readings[f"tf32 control d[:, {c0}:{c1}]"] = r
            checks[f"the D gate rejects TF32 logits d[:, {c0}:{c1}]"] = not r.pop("ok")
            del ctl
        del got, want, scale, limit
    sx, sw = flxent_abs_scales(x, w, lab, lse, gcoef, vocab_major, ulp, sub)
    for name, got, want, scale in (("dx", dx, dx_p, sx), ("dw", dw, dw_p, sw)):
        g, r = got.float(), want.float()
        err[name] = float((g - r).abs().max())
        err[name + "_rel_l2"] = rel_l2(g, r)
        readings[name] = gate_reading(g, r, scale + ulp * torch.maximum(g.abs(), r.abs()) + sub)
        checks[name] = readings[name].pop("ok") and err[name + "_rel_l2"] <= ulp / 2
        del g, r
    if route == "tf32x3":  # the split pass against its plain version, bitwise: x both ways, W's first chunk
        wc = w[:min(kl.CHUNK, v)] if vocab_major else w[:, :min(kl.CHUNK, v)].contiguous()
        err["split"] = 0.0
        for what, t in (("x", x), ("w chunk", wc)):
            got, want = kl.tf32_planes(t, True, True), kl.tf32_planes_plain(t, True, True)
            checks[f"split pass ({what}) is its plain version's bits"] = all(
                bool(torch.equal(a, b)) for a, b in zip(got, want))
            err["split"] = max(err["split"], *(float((a - b).abs().max()) for a, b in zip(got, want)))
            del got, want
        del wc
    checks["one product alone is the same bits"] = bool(torch.equal(dx, dx_only)) and bool(torch.equal(dw, dw_only))
    checks["two calls are the same bits"] = bool(torch.equal(dx, dx2)) and bool(torch.equal(dw, dw2))
    checks["two forward calls are the same bits"] = bool(torch.equal(lse, lse2)) and bool(torch.equal(tl, tl2))
    line = {"phase": "kernel_check", "kernel": "flxent_fwd/flxent_dchunk/flxent_dx/flxent_dw", "case": label,
            "route": route,
            "shape": {"x": [n, h], "w": list(w.shape), "vocab_major": vocab_major},
            "dtype": str(dtype).split(".")[-1], "max_err": err, "checks": checks, "gate_readings": readings,
            "tolerance": FLXENT_TOL}
    del dx_p, dw_p, dx_only, dw_only, dx2, dw2, sx, sw
    if not all(checks.values()):
        emit({**line, "card": card})
        fail(f"kernels 17-19 disagree with their plain versions ({label}): {checks} {err} {readings}")
    res = {"route": route,
           "max_abs_err": {"flxent_fwd": max(err["lse"], err["tl"]), "flxent_dchunk": err["d"],
                           "flxent_dx": err["dx"], "flxent_dw": err["dw"], "flxent_split": err.get("split")}}
    if timed:
        res.update(flxent_times(x, w, lab, lse, gcoef, vocab_major))
        line["times"] = res["times"]
        line["peak_memory"] = res["peak_memory"]
    emit({**line, "card": card})
    torch.cuda.empty_cache()
    return res


def fp32_fwd_readings(x, w, lab, lse, tl, lse_p, tl_p, vocab_major: bool, scale=None) -> dict:
    """Kernel 17's fp32 ``(lse, tl)`` against the plain version's (run with
    TF32 off by the caller) under :func:`fp32_fwd_gate`, and the control:
    the plain forward with TF32 on (one TF32 pass) under the same gate,
    ``"tf32 control"`` ``ok`` when either of lse and tl passes it (the
    caller requires it to fail)."""
    import torch
    from paddle_tpu_torch.kernels import fused_loss as kl

    scales = fp32_fwd_scales(x, w, lab, lse_p, vocab_major, scale)
    readings = fp32_fwd_gate(lse, tl, lse_p, tl_p, scales)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ctl = (kl.flxent_fwd_plain(x, w, lab, vocab_major) if scale is None
               else kl.flxent_fwd_int8_plain(x, w, scale, lab, vocab_major))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    ctl_r = fp32_fwd_gate(ctl[0], ctl[1], lse_p, tl_p, scales)
    readings["tf32 control"] = {"ok": ctl_r["lse"]["ok"] and ctl_r["tl"]["ok"],
                                "worst_err_over_limit": {k: r["worst_err_over_limit"] for k, r in ctl_r.items()}}
    return readings


def flxent_times(x, w, lab, lse, gcoef, vocab_major: bool) -> dict:
    """The times of kernels 17-19 and the D recompute (and of the backward
    with all three products, ``bwd_shared_d``), the plain versions' and the
    library's, each beside its bound at the peak rate of x's type (fp32: 67
    TFLOP/s outside the tensor cores), and the loss head's peak memory fused
    and unfused."""
    import torch
    from paddle_tpu_torch.kernels import fused_loss as kl
    from paddle_tpu_torch.nn.functional import cross_entropy

    n, h = x.shape
    v = w.shape[0] if vocab_major else w.shape[1]
    esz = x.element_size()
    rate = FP32_FLOP_PER_S if x.dtype == torch.float32 else BF16_FLOP_PER_S
    xw = (n * h + v * h) * esz  # x and W, each read once
    rows = 3 * n * 4  # labels, and lse / tl or lse / gcoef
    flop = 2.0 * n * h * v  # one product over the vocab
    # yardsticks only (the port never calls them): the unfused loss head,
    # cuBLAS x @ W then F.cross_entropy on fp32 logits, and its backward
    wt = w.t() if vocab_major else w
    lab64 = lab.long().where(lab < v, torch.full_like(lab.long(), -100))
    xr, wr = x.detach().requires_grad_(), wt.detach().requires_grad_()
    lib_loss = cross_entropy(xr @ wr, lab64, ignore_index=-100)
    vc = min(kl.CHUNK, v)  # the D recompute: one launch, the first vocab chunk
    runs = {
        "flxent_fwd": (lambda: kl.flxent_fwd(x, w, lab, vocab_major),
                       lambda: kl.flxent_fwd_plain(x, w, lab, vocab_major),
                       lambda: cross_entropy(x @ wt, lab64, ignore_index=-100),
                       bound(xw + rows, flop, rate)),
        "flxent_dchunk": (lambda: kl.flxent_dchunk(x, w, lab, lse, gcoef, 0, vc, vocab_major),
                          lambda: kl.flxent_dchunk_plain(x, w, lab, lse, gcoef, 0, vc, vocab_major),
                          None,
                          bound((n * h + vc * h + n * vc) * esz + rows, flop * vc / v, rate)),
        "flxent_dx": (lambda: kl.flxent_bwd(x, w, lab, lse, gcoef, vocab_major, need_dw=False),
                      lambda: kl.flxent_bwd_plain(x, w, lab, lse, gcoef, vocab_major, need_dw=False),
                      lambda: torch.autograd.grad(lib_loss, (xr, wr), retain_graph=True),
                      bound(xw + rows + n * h * esz, 2 * flop, rate)),
        "flxent_dw": (lambda: kl.flxent_bwd(x, w, lab, lse, gcoef, vocab_major, need_dx=False),
                      lambda: kl.flxent_bwd_plain(x, w, lab, lse, gcoef, vocab_major, need_dx=False),
                      lambda: torch.autograd.grad(lib_loss, (xr, wr), retain_graph=True),
                      bound(xw + rows + v * h * esz, 2 * flop, rate)),
    }
    times = {}
    for name, (run, run_plain, run_lib, bnd) in runs.items():
        times[name] = dict(ms=device_ms(run, iters=10), call_ms=call_ms(run, iters=10),
                           plain_ms=device_ms(run_plain, iters=2, warmup=1),
                           library_ms=None if run_lib is None else device_ms(run_lib, iters=5), **bnd)
        torch.cuda.empty_cache()
    times["bwd_shared_d"] = dict(ms=device_ms(lambda: kl.flxent_bwd(x, w, lab, lse, gcoef, vocab_major), iters=10),
                                 library_ms=times["flxent_dx"]["library_ms"],
                                 **bound(xw + rows + (n + v) * h * esz, 3 * flop, rate))
    if kl.flx_route_of(x, w, vocab_major) == "tf32x3":
        # three TF32 passes a product at the TF32 tensor peak (the bound above: one pass at 67 TFLOP/s)
        work = {"flxent_fwd": (xw + rows, 1), "flxent_dchunk": ((n * h + vc * h + n * vc) * esz + rows, vc / v),
                "flxent_dx": (xw + rows + n * h * esz, 2), "flxent_dw": (xw + rows + v * h * esz, 2),
                "bwd_shared_d": (xw + rows + (n + v) * h * esz, 3)}
        for name, (nbytes, products) in work.items():
            t = times[name]
            t["bound_ms_67_tflops"] = t["bound_ms"]
            t.update(bound(nbytes, 3 * products * flop, TF32_FLOP_PER_S))
            t["bound_note"] = "3 TF32 passes at 494.7 TFLOP/s; bound_ms_67_tflops: one pass at 67 TFLOP/s"
        sp = lambda: kl.tf32_planes(x, True, True)  # noqa: E731: the backward's x split (both orientations)
        times["flxent_split"] = dict(ms=device_ms(sp, iters=10), call_ms=call_ms(sp, iters=10),
                                     plain_ms=device_ms(lambda: kl.tf32_planes_plain(x, True, True), iters=3),
                                     library_ms=None, what="x [N, H] into x's and x^T's planes",
                                     **bound(n * h * 4 * 5, 0.0))  # read x once, write four planes
    for t in times.values():
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        if t.get("library_ms"):
            t["vs_library"] = t["ms"] / t["library_ms"]
    del lib_loss, xr, wr
    torch.cuda.empty_cache()

    def head_peak(fused: bool) -> float:
        """Peak device memory of the loss head alone, forward and backward
        with x and W gradients, above what was allocated before it."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
        if fused:
            loss = kl.linear_cross_entropy(xr, wr, lab, vocab_major=vocab_major)
        else:
            loss = cross_entropy(xr @ (wr.t() if vocab_major else wr), lab64, ignore_index=-100)
        loss.backward()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        del loss, xr, wr
        return peak

    peak = {"fused_gib": head_peak(True), "unfused_gib": head_peak(False)}
    return {"times": times, "peak_memory": peak}


def check_fused_loss(dev, gen, card: dict, records: dict) -> None:
    """Kernels 17-19 and the D recompute at the train shape (x ``[8192,
    4096]``, W ``[4096, 32000]`` bf16; timed, 17 gated at
    :data:`FLX_FWD_GATE` times the library's forward and 18 and 19 each at
    :data:`FLX_GATE` times the library's whole backward in the same call), at
    a ragged vocab and row count (V 32003, whose ``[H, V]`` rows are not
    16-byte aligned: the mma.sync route), in the vocab-major layout, in
    fp16 (ragged V 3001 on the mma.sync route; V 3000 in both layouts on
    the wgmma route), at ragged rows and a last chunk of 904 columns on
    the wgmma route, at H 520 (a partial k box on the wgmma route), with W
    2 bytes off 16-byte alignment (the mma.sync route), at GPT-3 13B's
    tied head (x ``[8192, 5120]``, W ``[50304, 5120]`` vocab-major, a
    1152-column tail chunk; timed), and in fp32 (kernel 17 and the
    backward on the 3xTF32 instance, ``csrc/flxent_tf32.cu``, in a ragged
    vocab-major case, vocab-major cases at x ``[2048, 4096]`` and ``[8192,
    4096]``, and x ``[2048, 4096]`` and ``[8192, 4096]`` against W ``[4096,
    32000]`` timed beside the fp32 library head with TF32 off, 17 gated at
    :data:`FLX_FP32_FWD_GATE` times its forward at both row counts, 18 and
    19 at :data:`FLX_FP32_GATE` times its backward at 2048 rows, and the
    fused head's peak memory below the unfused head's; on the CUDA cores
    where W ``[H, V]`` has V % 4 != 0); then the public
    ``F.fused_linear_cross_entropy`` on fp32 tensors. First the host's copy
    of the wgmma instance's tile plan is held against the kernels' own."""
    import torch

    bf, f16 = torch.bfloat16, torch.float16
    check_flx_plan(card)
    train = flxent_case(dev, gen, 8192, 4096, 32000, bf, False, "train shape", card, "wgmma", timed=True)
    flxent_case(dev, gen, 1000, 1024, 32003, bf, False, "ragged rows and vocab (V % 8 != 0)", card, "mma_sync")
    flxent_case(dev, gen, 2048, 1024, 5000, bf, True, "vocab-major W [V, H]", card, "wgmma")
    flxent_case(dev, gen, 1000, 1024, 5000, bf, False, "ragged rows, a 904-column last chunk", card, "wgmma")
    flxent_case(dev, gen, 520, 512, 3001, f16, False, "fp16, ragged", card, "mma_sync")
    flxent_case(dev, gen, 520, 512, 3000, f16, False, "fp16, ragged rows and chunk", card, "wgmma")
    flxent_case(dev, gen, 520, 512, 3000, f16, True, "fp16, ragged rows and chunk, vocab-major", card, "wgmma")
    flxent_case(dev, gen, 300, 520, 1000, bf, True, "H 520 (a partial k box), ragged rows, vocab-major", card,
                "wgmma")
    flxent_case(dev, gen, 1000, 1024, 5000, bf, False, "W 2 bytes off 16-byte alignment", card, "mma_sync",
                w_offset=1)
    gpt = flxent_case(dev, gen, 8192, 5120, 50304, bf, True, "GPT-3 13B tied head: W [50304, 5120], a 1152-column "
                      "tail chunk", card, "wgmma", timed=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        flxent_case(dev, gen, 300, 256, 1000, torch.float32, True, "fp32, ragged, vocab-major", card, "tf32x3")
        flxent_case(dev, gen, 520, 512, 3001, torch.float32, False, "fp32, W [H, V] with V % 4 != 0", card,
                    "cuda_cores")
        flxent_case(dev, gen, 2048, 4096, 32000, torch.float32, True, "fp32, 2048 rows, vocab-major", card,
                    "tf32x3")
        fp32 = flxent_case(dev, gen, 2048, 4096, 32000, torch.float32, False, "fp32, 2048 rows", card, "tf32x3",
                           timed=True)
        flxent_case(dev, gen, 8192, 4096, 32000, torch.float32, True, "fp32, 8192 rows, vocab-major", card,
                    "tf32x3")
        fp32_step = flxent_case(dev, gen, 8192, 4096, 32000, torch.float32, False,
                                "fp32, 8192 rows (the fp32 train step's head)", card, "tf32x3", timed=True)
        check_fused_loss_fp32_entry(dev, gen, card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for name, src in FLXENT_SOURCES.items():
        t = train["times"][name]
        records[name] = dict(source=src, max_abs_err=train["max_abs_err"][name], **t)
    records["flxent_dx"]["bwd_shared_d"] = train["times"]["bwd_shared_d"]
    records["flxent_fwd"]["sources"] = {"wgmma (bf16 / fp16)": FLXENT_SOURCES["flxent_fwd"],
                                        "tf32x3 (fp32)": FLXENT_TF32_SOURCE,
                                        "mma_sync (bf16 / fp16 W TMA cannot address)":
                                            "paddle_tpu_torch/kernels/csrc/flxent_fwd.cu",
                                        "cuda_cores (fp32 W the split pass cannot read)":
                                            "paddle_tpu_torch/kernels/csrc/flxent_fp32.cu"}
    # the split pass runs on the fp32 route only: its record at the fp32 train step's x [8192, 4096]
    records["flxent_split"] = dict(source=FLXENT_TF32_SOURCE, max_abs_err=fp32_step["max_abs_err"]["flxent_split"],
                                   **fp32_step["times"]["flxent_split"])
    emit({"phase": "flxent_times", "train_shape": {"x": [8192, 4096], "w": [4096, 32000]},
          "routes": {"train": train["route"], "gpt": gpt["route"], "fp32": fp32["route"]},
          "library": "two calls: cuBLAS x @ W + F.cross_entropy on fp32 logits; its backward (dlogits, dX, dW) "
                     "stands beside 18, 19 and bwd_shared_d; none for the D recompute",
          "note": "flxent_dchunk's ms is one launch (the first 4096 columns); flxent_dx's and flxent_dw's are "
                  "the whole backward with one product, their D recomputes included; bwd_shared_d is the main "
                  "path's backward (D, dX and dW per chunk)",
          "records": {n: records[n] for n in FLXENT_SOURCES}, "bwd_shared_d": train["times"]["bwd_shared_d"],
          "gpt_head": gpt["times"], "gpt_peak_memory": gpt["peak_memory"],
          "fp32_2048_rows": fp32["times"], "fp32_8192_rows": fp32_step["times"],
          "fp32_route": fp32["route"],
          "fp32_peak_memory": {"2048_rows": fp32["peak_memory"], "8192_rows": fp32_step["peak_memory"]},
          "fp32_library": "the same two calls in fp32, TF32 off",
          "loss_head_peak_memory": train["peak_memory"], "card": card})
    ratios = {name: train["times"][name]["vs_library"] for name in ("flxent_dx", "flxent_dw")}
    fwd_ratio = train["times"]["flxent_fwd"]["vs_library"]
    emit({"phase": "flxent_gate", "ms_over_library_bwd": ratios, "limit": FLX_GATE,
          "fwd_ms_over_library_fwd": fwd_ratio, "fwd_limit": FLX_FWD_GATE,
          "gpt_fwd_ms_over_library_fwd": gpt["times"]["flxent_fwd"]["vs_library"],
          "share_of_bound": {name: train["times"][name]["share_of_bound"] for name in train["times"]},
          "gpt_share_of_bound": {name: gpt["times"][name]["share_of_bound"] for name in gpt["times"]},
          "card": card})
    slow = {name: r for name, r in ratios.items() if r > FLX_GATE}
    if slow:
        fail(f"kernels 18/19 are slower than {FLX_GATE}x the library's whole backward at the train shape: {slow}")
    if fwd_ratio > FLX_FWD_GATE:
        fail(f"kernel 17 is slower than {FLX_FWD_GATE}x the library's forward at the train shape: {fwd_ratio}")
    fp32_ratios = {name: fp32["times"][name]["vs_library"] for name in ("flxent_dx", "flxent_dw")}
    fwd_fp32 = {rows: case["times"]["flxent_fwd"] for rows, case in (("2048_rows", fp32), ("8192_rows", fp32_step))}
    shared = fp32["times"]["bwd_shared_d"]
    emit({"phase": "flxent_fp32_gate", "x": [2048, 4096], "w": [4096, 32000],
          "ms_over_library_bwd": fp32_ratios, "limit": FLX_FP32_GATE,
          "fwd": {rows: {k: t[k] for k in ("ms", "library_ms", "vs_library", "bound_ms", "share_of_bound",
                                             "bound_ms_67_tflops", "plain_ms", "call_ms")}
                  for rows, t in fwd_fp32.items()},
          "route": fp32["route"], "fwd_limit": FLX_FP32_FWD_GATE,
          "bwd_shared_d": {"ms": shared["ms"], "vs_library": shared["vs_library"],
                           "share_of_3_pass_bound": shared["share_of_bound"], "bound_ms": shared["bound_ms"]},
          "at_8192_rows": {name: fp32_step["times"][name].get("vs_library") for name in fp32_step["times"]},
          "fwd_ms_8192_rows": fp32_step["times"]["flxent_fwd"]["ms"],
          "library": "cuBLAS x @ W + F.cross_entropy in fp32 with TF32 off, and its backward", "card": card})
    slow = {name: r for name, r in fp32_ratios.items() if r > FLX_FP32_GATE}
    if slow:
        fail(f"kernels 18/19 in fp32 are slower than {FLX_FP32_GATE}x the library's fp32 backward: {slow}")
    slow = {rows: t["vs_library"] for rows, t in fwd_fp32.items() if t["vs_library"] > FLX_FP32_FWD_GATE}
    if slow:
        fail(f"kernel 17 in fp32 is slower than {FLX_FP32_FWD_GATE}x the library's fp32 forward: {slow}")
    for label, case in (("bf16 train shape", train), ("fp32, 2048 rows", fp32), ("fp32, 8192 rows", fp32_step)):
        if not case["peak_memory"]["fused_gib"] < case["peak_memory"]["unfused_gib"]:
            fail(f"the fused loss head's peak memory is not below the unfused head's ({label}): "
                 f"{case['peak_memory']}")
    torch.cuda.empty_cache()


def check_flx_plan(card: dict) -> None:
    """The host's copy of the wgmma instance's tile plan
    (``fused_loss.flx_plan`` and ``flx_items``) against the plan the
    kernels launch on (``ptt_flxent_plan``), on this card's SM count: the
    outputs of D and dX at the train shapes (Llama's 4096- and
    3328-column chunks, GPT's H 5120 and 1152-column tail), dW in both
    layouts, and ragged shapes."""
    import ctypes

    import torch
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels import fused_loss as kl

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fn = build.kernel_fn("ptt_flxent_plan", [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_int])
    shapes = [(8192, 4096), (8192, 3328), (4096, 4096), (4096, 3328), (8192, 5120), (5120, 4096), (8192, 1152),
              (1152, 5120), (1000, 5000), (1000, 904), (520, 3000), (3000, 512), (300, 1000), (160, 8)]
    wrong = []
    for m, n in shapes:
        py = kl.flx_plan(m, n, sms)
        plan = (ctypes.c_int * 5)()
        cap = 2 * py["tiles_m"] * py["tiles_n"]
        items = (ctypes.c_int * (3 * cap))()
        build.check(fn(m, n, sms, ctypes.addressof(plan), ctypes.addressof(items), cap), "ptt_flxent_plan")
        cc = dict(zip(("tiles_m", "tiles_n", "big", "items", "grid"), plan))
        cc_items = [tuple(items[3 * i:3 * i + 3]) for i in range(min(cc["items"], cap))]
        if cc != py or cc_items != kl.flx_items(py):
            wrong.append({"shape": [m, n], "kernels": cc, "host": py})
    emit({"phase": "flx_plan_check", "sms": sms, "shapes": shapes, "ok": not wrong, "card": card})
    if wrong:
        fail(f"flx_plan / flx_items disagree with the kernels' tile plan: {wrong}")


def loss_head_launches(n: int, h: int, v: int, dtype, vocab_major: bool) -> dict:
    """The launches of one forward and backward of the fused loss head for
    ``x [n, h]`` against a vocab of ``v`` on the routes its shapes take (W
    16-byte aligned): kernel 17's partials and merge, per vocab chunk of
    ``CHUNK`` columns one D, one dX, one dW; on ``"tf32x3"`` kernel 17's
    partials one per sub-chunk of ``flx_fwd_sub`` columns and the backward's
    products one per sub-chunk of ``flx_tf32_sub`` columns, with a split
    launch for x and for each sub-chunk of W, forward and backward."""
    from paddle_tpu_torch.kernels import fused_loss as kl

    if kl.flx_route(dtype, h, v, vocab_major) != "tf32x3":
        chunks = -(-v // kl.CHUNK)
        return {"flxent_fwd": 2, "flxent_dchunk": chunks, "flxent_dx": chunks, "flxent_dw": chunks}
    fwd_subs = -(-v // kl.flx_fwd_sub(n, h, v))
    subs = -(-v // kl.flx_tf32_sub(n, h, v))
    return {"flxent_fwd": fwd_subs + 1, "flxent_split": (1 + fwd_subs) + (1 + subs), "flxent_dchunk": subs,
            "flxent_dx": subs, "flxent_dw": subs}


def check_fused_loss_fp32_entry(dev, gen, card: dict) -> None:
    """``F.fused_linear_cross_entropy`` forward and backward on fp32 tensors
    on the card (H 1024, a multiple of 128: the kernels' gate, the flag at its
    default) on the 3xTF32 instance with the launches
    :func:`loss_head_launches` counts (17: a split of x, per sub-chunk of
    ``flx_fwd_sub`` columns a split of W's and a partials launch, the merge;
    the backward: a split of x, per sub-chunk of ``flx_tf32_sub`` columns a
    split of W's, D, 18 and 19), against the same entry on the plain
    versions; loss within 1e-5 relative, each gradient within a relative L2
    of 1e-5 (the same fp32 products summed in other orders)."""
    import torch
    from paddle_tpu_torch.kernels import fused_loss as kl
    from paddle_tpu_torch.kernels.select import launch_counts, reset_launch_counts
    from paddle_tpu_torch.nn import functional as F

    b, s, h, v = 2, 300, 1024, 5000
    x0 = torch.randn((b, s, h), generator=gen, device=dev)
    w0 = 0.02 * torch.randn((h, v), generator=gen, device=dev)
    lab = torch.randint(0, v, (b, s), generator=gen, device=dev)
    lab[:, ::7] = -100
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    torch.cuda.synchronize()
    reset_launch_counts()
    loss = F.fused_linear_cross_entropy(x, w, lab)
    loss.backward()
    torch.cuda.synchronize()
    counts = {k: c for k, c in launch_counts().items() if c}
    xp, wp = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    loss_p = kl.linear_cross_entropy(xp, wp, lab, use_kernels=False)
    loss_p.backward()
    want = loss_head_launches(b * s, h, v, torch.float32, False)
    err = {"loss": abs(float(loss.detach()) - float(loss_p.detach())) / abs(float(loss_p.detach())),
           "dx_rel_l2": rel_l2(x.grad, xp.grad), "dw_rel_l2": rel_l2(w.grad, wp.grad)}
    ok = counts == want and all(e <= 1e-5 for e in err.values()) and loss.dtype == torch.float32
    emit({"phase": "fused_loss_fp32_entry", "shape": {"x": [b, s, h], "w": [h, v]},
          "route": kl.flx_route(torch.float32, h, v, False), "launches": counts, "errors": err,
          "tolerance": "loss 1e-5 relative; dx, dw rel L2 <= 1e-5", "card": card})
    if not ok:
        fail(f"F.fused_linear_cross_entropy in fp32 on the card: launches {counts} (want {want}), errors {err}")


# -- serving -------------------------------------------------------------------

def plain_logits(model, ids, caches, tables, lens, active, q_lens, dtype):
    """The same step as ``model(ids, pasts)``, written out with every
    kernel's plain version, computed in ``dtype`` (each weight cast as it is
    used): in bf16 it is the plain path the kernel path is held to, in fp32
    the reference both are measured against (fp64 for an fp32 model). A
    weight-only int8 projection runs kernel 20's plain version on its int8
    weight (in fp64, the same product in fp64), and an int8 pool (``caches``
    of ``(kc, vc, ks, vs)``) its scale planes."""
    import torch
    from paddle_tpu_torch.incubate.nn.functional import _rope_apply_xla, block_cache_append_chunk
    from paddle_tpu_torch.kernels.fused import fused_embed_rms_norm_plain, fused_rms_norm_residual_plain
    from paddle_tpu_torch.kernels.paged_attention import paged_flash_chunk_fused_plain
    from paddle_tpu_torch.kernels.quant import int8_weight_matmul_plain
    from paddle_tpu_torch.nn.functional import swiglu

    def w(mod):
        return mod.weight.to(dtype)

    def proj(x, mod):
        if mod.weight_scale is None:
            return x @ w(mod)
        if dtype == torch.float64:  # the reference of an fp32 model: the int8 product in fp64 too
            return (x @ mod.weight.to(dtype)) * mod.weight_scale.to(dtype)
        return int8_weight_matmul_plain(x, mod.weight, mod.weight_scale)

    llama = model.llama
    layers = list(llama.layers)
    b, c = ids.shape
    first = layers[0].input_layernorm
    residual, h = fused_embed_rms_norm_plain(ids, w(llama.embed_tokens), w(first), first.epsilon)
    cos, sin = llama.rotary_emb(c, lens)
    attend = torch.where(active, q_lens, torch.zeros_like(q_lens))
    for i, layer in enumerate(layers):
        att, mlp = layer.self_attn, layer.mlp
        nh, nkv, hd = att.num_heads, att.num_kv_heads, att.head_dim
        q = (h @ w(att.q_proj)).reshape(b, c, nh, hd)
        k = _rope_apply_xla((h @ w(att.k_proj)).reshape(b, c, nkv, hd), sin, cos, True)
        v = (h @ w(att.v_proj)).reshape(b, c, nkv, hd)
        kc, vc, *planes = caches[i]
        ks, vs = planes or (None, None)
        block_cache_append_chunk(kc, vc, k, v, tables, lens, q_lens, slot_mask=active, key_scale=ks, value_scale=vs)
        a = paged_flash_chunk_fused_plain(q, cos.reshape(b, c, hd), sin.reshape(b, c, hd), kc, vc, tables, lens, attend,
                                          k_scale=ks, v_scale=vs)
        post = layer.post_attention_layernorm
        h, residual = fused_rms_norm_residual_plain(a.reshape(b, c, nh * hd) @ w(att.o_proj), w(post), residual, post.epsilon)
        m = proj(swiglu(proj(h, mlp.gate_proj), proj(h, mlp.up_proj)), mlp.down_proj)
        nxt = layers[i + 1].input_layernorm if i + 1 < len(layers) else llama.norm
        h, residual = fused_rms_norm_residual_plain(m, w(nxt), residual, nxt.epsilon)
    return proj(h, model.lm_head)


def check_logits(model, dev, card: dict, label: str = "logits", kv_int8: bool = False) -> None:
    """Phase 5: prefill a small pool through the kernel path, then run one
    mixed step (decode row, continuing chunk, idle slot, full chunk) through
    the kernel path, through the plain versions in the model's dtype (bf16
    for the 7B model), and through the plain versions in a higher precision
    (fp32; fp64 for an fp32 model) on copies of the pool. A bf16 path's
    rounding differences grow through 32 layers of random weights, so the
    kernel path is held to the plain path's own distance from the
    higher-precision reference: its relative L2 error may exceed the plain
    path's by at most 25%, and its top-1 agreement may trail the plain
    path's by at most 0.05. With ``kv_int8`` the pool is the engine's int8
    one (8-tuple pasts); a weight-only int8 model's projections stay int8 in
    every run."""
    import torch

    cfg = model.config
    hd = cfg.hidden_size // cfg.num_attention_heads
    shape = (64, cfg.num_key_value_heads, 16, hd)
    if kv_int8:
        caches = [(torch.zeros(shape, dtype=torch.int8, device=dev), torch.zeros(shape, dtype=torch.int8, device=dev),
                   torch.ones(shape[:3], device=dev), torch.ones(shape[:3], device=dev))
                  for _ in range(cfg.num_hidden_layers)]
    else:
        caches = [(torch.zeros(shape, dtype=model.dtype, device=dev), torch.zeros(shape, dtype=model.dtype, device=dev))
                  for _ in range(cfg.num_hidden_layers)]
    gen = torch.Generator(device=dev).manual_seed(3)
    tables = torch.arange(64, dtype=torch.int32, device=dev).reshape(4, 16)
    active = torch.tensor([True, True, False, True], device=dev)
    with torch.inference_mode():
        ids = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen, device=dev)
        q0 = torch.tensor([64, 40, 0, 64], dtype=torch.int32, device=dev)
        lens = torch.zeros_like(q0)
        model(ids, past_key_values=[(kc, vc, tables, lens, active, q0, *planes) for kc, vc, *planes in caches],
              use_cache=True, cache_position=lens)
        plain_pools = [tuple(t.clone() for t in pools) for pools in caches]
        # higher-precision copies of a float pool; an int8 pool and its fp32 scale planes are copied as they are
        ref_dtype = torch.float64 if model.dtype == torch.float32 else torch.float32
        ref_pools = [tuple(t.clone() if kv_int8 else t.to(ref_dtype) for t in pools) for pools in caches]
        q1 = torch.tensor([1, 24, 0, 64], dtype=torch.int32, device=dev)
        ids = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen, device=dev)
        got, _ = model(ids, past_key_values=[(kc, vc, tables, q0, active, q1, *planes) for kc, vc, *planes in caches],
                       use_cache=True, cache_position=q0)
        got = got.float()
        plain = plain_logits(model, ids, plain_pools, tables, q0, active, q1, model.dtype).float()
        ref = plain_logits(model, ids, ref_pools, tables, q0, active, q1, ref_dtype).float()
    rows = torch.arange(64, device=dev)[None, :] < (q1 * active)[:, None]
    logits_gate(got[rows], plain[rows], ref[rows], label, card)


def logits_gate(got, plain, ref, label: str, card: dict, gate_top1: bool = True) -> None:
    """The kernel path's logits ``got`` against the plain bf16 path's and
    the fp32 reference's, row by row (``[rows, V]``): relative L2 error at
    most 1.25x the plain path's, all finite, and (``gate_top1``) top-1
    agreement with the reference within 0.05 of the plain path's."""
    import torch

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    def top1(a, b):
        return float((a.argmax(-1) == b.argmax(-1)).float().mean())

    out = {"kernel_vs_fp32_rel_l2": rel(got, ref), "plain_vs_fp32_rel_l2": rel(plain, ref),
           "kernel_vs_plain_rel_l2": rel(got, plain), "kernel_vs_fp32_top1": top1(got, ref),
           "plain_vs_fp32_top1": top1(plain, ref), "kernel_vs_plain_max_abs_err": float((got - plain).abs().max())}
    ok = out["kernel_vs_fp32_rel_l2"] <= 1.25 * out["plain_vs_fp32_rel_l2"] and bool(torch.isfinite(got).all())
    tol = "kernel_vs_fp32_rel_l2 <= 1.25 * plain_vs_fp32_rel_l2"
    if gate_top1:
        ok = ok and out["kernel_vs_fp32_top1"] >= out["plain_vs_fp32_top1"] - 0.05
        tol += "; top1 within 0.05 of plain's"
    emit({"phase": label, "rows": got.shape[0], **out, "tolerance": tol, "card": card})
    if not ok:
        fail(f"{label}: kernel-path logits are further from the fp32 reference than the plain path's: {out}")


def plain_decode_logits(model, tok, caches, tables, lens, dtype):
    """One ``generate_paged`` decode step (``tok [B]``, pools holding
    ``lens`` tokens) written out with the plain versions, computed in
    ``dtype`` (each weight cast as it is used)."""
    import torch
    from paddle_tpu_torch.incubate.nn.functional import _rope_apply_xla, block_cache_append
    from paddle_tpu_torch.kernels.fused import rms_norm_fwd_plain
    from paddle_tpu_torch.kernels.paged_attention import paged_flash_decode_plain
    from paddle_tpu_torch.nn.functional import swiglu

    def w(mod):
        return mod.weight.to(dtype)

    def norm(x, mod):
        return rms_norm_fwd_plain(x, w(mod), mod.epsilon)[0]

    llama = model.llama
    b = tok.shape[0]
    h = w(llama.embed_tokens)[tok.long()][:, None]
    cos, sin = llama.rotary_emb(1, lens)
    for i, layer in enumerate(llama.layers):
        att, mlp = layer.self_attn, layer.mlp
        nh, nkv, hd = att.num_heads, att.num_kv_heads, att.head_dim
        x = norm(h, layer.input_layernorm)
        q = _rope_apply_xla((x @ w(att.q_proj)).reshape(b, 1, nh, hd), sin, cos, True)
        k = _rope_apply_xla((x @ w(att.k_proj)).reshape(b, 1, nkv, hd), sin, cos, True)
        v = (x @ w(att.v_proj)).reshape(b, 1, nkv, hd)
        kc, vc = caches[i]
        block_cache_append(kc, vc, k[:, 0], v[:, 0], tables, lens)
        a = paged_flash_decode_plain(q[:, 0], kc, vc, tables, lens + 1)
        h = h + a.reshape(b, 1, nh * hd) @ w(att.o_proj)
        x = norm(h, layer.post_attention_layernorm)
        h = h + swiglu(x @ w(mlp.gate_proj), x @ w(mlp.up_proj)) @ w(mlp.down_proj)
    return norm(h, llama.norm) @ w(model.lm_head)


def check_decode_logits(model, dev, card: dict) -> None:
    """One ``generate_paged`` decode step (32 sequences of 64 prompt tokens,
    prefilled through the kernel path) through the kernel path (kernel 5),
    through the plain versions in bf16 and in fp32 on copies of the pools:
    the relative L2 gate of :func:`logits_gate`. Top-1 agreement over 32
    single rows moves by 1/32 a flip, so it is reported, not gated."""
    import torch
    from paddle_tpu_torch.incubate.nn.functional import block_cache_prefill

    cfg = model.config
    hd = cfg.hidden_size // cfg.num_attention_heads
    b, s, bs = 32, 64, 16
    gen = torch.Generator(device=dev).manual_seed(4)
    tables = torch.arange(b * 5, dtype=torch.int32, device=dev).reshape(b, 5)  # 4 prompt blocks + 1
    lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        ids = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
        logits, dense = model(ids, use_cache=True)
        pools = []
        for k, v in dense:
            kc = torch.zeros((b * 5, cfg.num_key_value_heads, bs, hd), dtype=model.dtype, device=dev)
            pools.append(block_cache_prefill(kc, torch.zeros_like(kc), k, v, tables, lens))
        del dense, logits
        tok = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=dev, dtype=torch.int32)
        plain_pools = [(kc.clone(), vc.clone()) for kc, vc in pools]
        f32_pools = [(kc.float(), vc.float()) for kc, vc in pools]
        got, _ = model(tok[:, None], past_key_values=[(kc, vc, tables, lens) for kc, vc in pools],
                       use_cache=True, cache_position=lens)
        plain = plain_decode_logits(model, tok, plain_pools, tables, lens, torch.bfloat16).float()
        ref = plain_decode_logits(model, tok, f32_pools, tables, lens, torch.float32)
    logits_gate(got[:, 0].float(), plain[:, 0], ref[:, 0], "logits_decode", card, gate_top1=False)


GEN_SHAPE = (8, 512, 32)  # prompts, prompt tokens, new tokens


def generate_paged_phase(model, dev, card: dict) -> dict:
    """Phase 4c: ``model.generate_paged`` at Llama-2-7B width on 8 seeded
    prompts of 512 tokens, 32 new tokens, ``block_size=16``, after a small
    warm-up call. Forward hooks snapshot the launch counters and record a
    CUDA event around every model call: the prefill must launch flash_fwd
    32x, rope_fwd 64x and rms_norm_fwd 65x, each of the 31 decode steps
    paged_decode 32x and rms_norm_fwd 65x, and nothing else; the output is
    ``[8, 544]`` int32 with the prompts in front; every block is freed (the
    call's allocator is local, so its ``free`` is checked by counting). The
    host syncs of the timed call are counted under
    ``torch.cuda.set_sync_debug_mode("warn")``. Returns the call's launch
    counts."""
    import warnings

    import numpy as np
    import torch
    from paddle_tpu_torch.incubate.nn.functional import block_attention
    from paddle_tpu_torch.kernels.select import KERNELS, launch_counts, reset_launch_counts

    cfg = model.config
    b, prompt, new = GEN_SHAPE
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, prompt)).astype(np.int32)).to(dev)
    model.generate_paged(ids[:2, :64], max_new_tokens=4, block_size=16)  # warm-up
    snaps, marks = [], []

    def pre(mod, args, kwargs):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        snaps.append(launch_counts())

    def post(mod, args, kwargs, out):
        snaps.append(launch_counts())

    freed = []
    real_free = block_attention.BlockKVCache.free

    def counting_free(self, seq_id):
        freed.append(self.blocks_allocated(seq_id))
        real_free(self, seq_id)

    hooks = [model.register_forward_pre_hook(pre, with_kwargs=True),
             model.register_forward_hook(post, with_kwargs=True)]
    block_attention.BlockKVCache.free = counting_free
    torch.cuda.synchronize()
    reset_launch_counts()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                out = model.generate_paged(ids, max_new_tokens=new, block_size=16)
                end = torch.cuda.Event(enable_timing=True)
                end.record()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        for h in hooks:
            h.remove()
        block_attention.BlockKVCache.free = real_free
    counts = launch_counts()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    deltas = [{k: after[k] - before[k] for k in KERNELS if after[k] != before[k]}
              for before, after in zip(snaps[0::2], snaps[1::2])]
    marks.append(end)
    step_ms = [a.elapsed_time(z) for a, z in zip(marks[:-1], marks[1:])]
    decode_ms = float(np.median(step_ms[1:]))
    blocks = -(-(prompt + new) // 16)
    emit({"phase": "generate_paged", "model": "llama2_7b (seeded random bf16 weights)", "batch": b,
          "prompt_tokens": prompt, "new_tokens": new, "block_size": 16, "calls": len(deltas),
          "prefill_launches": deltas[0] if deltas else None,
          "decode_launches_per_step": deltas[1] if len(deltas) > 1 else None,
          "wall_s": wall_s, "prefill_ms": step_ms[0], "decode_ms_per_step_p50": decode_ms,
          "decode_ms_per_step_mean": float(np.mean(step_ms[1:])), "decode_tokens_per_s": b * 1e3 / decode_ms,
          "weights_bound_ms": WEIGHT_BYTES_7B / HBM_BYTES_PER_S * 1e3,
          "decode_step_over_weights_bound": decode_ms / (WEIGHT_BYTES_7B / HBM_BYTES_PER_S * 1e3),
          "host_syncs": syncs, "blocks_freed": sum(freed), "launches": counts, "card": card})
    layers = cfg.num_hidden_layers
    want_prefill = {"flash_fwd": layers, "rope_fwd": 2 * layers, "rms_norm_fwd": 2 * layers + 1}
    want_decode = {"paged_decode": layers, "rms_norm_fwd": 2 * layers + 1}
    if tuple(out.shape) != (b, prompt + new) or out.dtype != torch.int32 or not torch.equal(out[:, :prompt], ids):
        fail(f"generate_paged returned {tuple(out.shape)} {out.dtype}, want [{b}, {prompt + new}] int32 after the prompts")
    if len(deltas) != new or deltas[0] != want_prefill or any(d != want_decode for d in deltas[1:]):
        fail(f"generate_paged launches: prefill {deltas[:1]}, decode steps {deltas[1:3]}...; want "
             f"{want_prefill} then {new - 1} x {want_decode}")
    if sum(freed) != b * blocks or len(freed) != b:
        fail(f"generate_paged freed {freed}, want {b} sequences of {blocks} blocks")
    if int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        fail("generate_paged emitted a token outside the vocabulary")
    profile_decode(model, ids, card)
    check_decode_logits(model, dev, card)
    return counts


def check_decode_entry(dev, gen, card: dict, fused: bool = True, int8: bool = False) -> dict:
    """Phase 4d: one public decode entry at the 7B decode shape (8 slots,
    32 heads of 128, block 16, an idle masked slot, garbage table tails) —
    ``block_multihead_attention_fused`` (kernel 6) with ``fused``, else
    ``block_multihead_attention`` (kernel 5), over the int8 pool (their
    ``_int8`` instances) with ``int8``: one launch of its kernel and nothing
    else; the output against the plain version on the same pools; the pools
    (and scale planes) bit for bit those of the plain append (k roped by the
    same composition for the fused entry, quantized for the int8 pool,
    written through a boolean mask). Returns the launch counts."""
    import torch
    from paddle_tpu_torch.incubate.nn.functional import (
        _rope_apply_xla, block_multihead_attention, block_multihead_attention_fused,
    )
    from paddle_tpu_torch.incubate.nn.functional.block_attention import _quantize_kv_rows
    from paddle_tpu_torch.kernels.paged_attention import paged_flash_decode_fused_plain, paged_flash_decode_plain
    from paddle_tpu_torch.kernels.select import KERNELS, launch_counts, reset_launch_counts

    args, _ = decode_batch(dev, gen, 32, 32)
    pools = int8_pool(args) if int8 else args
    names = ("key_cache", "value_cache", "k_scale", "v_scale") if int8 else ("key_cache", "value_cache")
    tables, lens_in = args["block_tables"], args["seq_lens"]
    active = lens_in > 0
    seq_lens = (lens_in - 1).clamp(min=0)  # tokens cached before this one
    b, hq, d = args["q"].shape
    q = args["q"][:, None]
    k, v = (torch.randn((b, 1, 32, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    cos, sin = args["cos"][:, :, None], args["sin"][:, :, None]
    kr = _rope_apply_xla(k, sin, cos, True) if fused else k
    rows = (*_quantize_kv_rows(kr[:, 0]), *_quantize_kv_rows(v[:, 0])) if int8 else (kr[:, 0], v[:, 0])
    rows = (rows[0], rows[2], rows[1], rows[3]) if int8 else rows  # in the order of `names`
    want = [pools[n].clone() for n in names]
    bs = want[0].shape[2]
    phys = torch.gather(tables.long(), 1, (seq_lens.long() // bs)[:, None])[:, 0][active]
    off = (seq_lens.long() % bs)[active]
    for plane, new in zip(want, rows):
        plane[phys, :, off] = new[active]
    attend = torch.where(active, seq_lens + 1, torch.zeros_like(seq_lens))
    planes = dict(k_scale=want[2], v_scale=want[3]) if int8 else {}
    ref = (paged_flash_decode_fused_plain(args["q"], args["cos"], args["sin"], *want[:2], tables, attend, **planes)
           if fused else paged_flash_decode_plain(args["q"], *want[:2], tables, attend, **planes))
    got = [pools[n] for n in names]
    entry_planes = dict(key_scale=got[2], value_scale=got[3]) if int8 else {}
    torch.cuda.synchronize()
    reset_launch_counts()
    if fused:
        out = block_multihead_attention_fused(q, k, v, cos, sin, *got[:2], tables, seq_lens, slot_mask=active,
                                              **entry_planes)[0]
    else:
        out = block_multihead_attention(q, k, v, *got[:2], tables, seq_lens, slot_mask=active, **entry_planes)[0]
    counts = launch_counts()
    torch.cuda.synchronize()
    name = ("paged_decode_fused" if fused else "paged_decode") + "_int8" * int8
    err, ok = within(out[:, 0], ref, *PAGED_TOL["bfloat16"])
    same = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
    idle_zero = bool((out[6] == 0).all())
    emit({"phase": "decode_" + ("fused" if fused else "plain") + "_int8" * int8, "shape": [b, 1, hq, d],
          "launches": {n: c for n, c in counts.items() if c}, "max_abs_err": err, "tolerance": "1e-4 + 2^-7*|x|",
          "pools_bitwise_equal_to_plain_append": same, "idle_slot_zero": idle_zero, "card": card})
    entry = "block_multihead_attention" + "_fused" * fused
    if counts != {n: int(n == name) for n in KERNELS}:
        fail(f"{entry} launched {counts}, want {name} once and nothing else")
    if not (ok and same and idle_zero):
        fail(f"{entry}: max abs err {err}, pools bitwise {same}, idle slot zero {idle_zero}")
    return counts


KERNEL_CATEGORIES = (  # device kernel name substring -> category
    ("paged_chunk_kernel", "attention (kernels A / 4)"), ("paged_decode_kernel", "attention (kernels 5 / 6)"),
    ("wo_matmul", "weight-only int8 matmul (kernel 20)"),
    ("embed_rms", "embed_rms (kernel B)"), ("rms_fwd_kernel", "rmsnorm (kernel 7)"),
    ("rms_residual", "rms_residual (kernel C)"), ("flash_fwd_kernel", "flash fwd (kernel 14)"),
    ("gemm", "matmul"), ("cutlass", "matmul"), ("xmma", "matmul"), ("nvjet", "matmul"),
    ("Memcpy", "memcpy"), ("Memset", "memcpy"),
    ("index", "kv append / gathers"), ("nonzero", "kv append / gathers"), ("gather", "kv append / gathers"),
    ("scatter", "kv append / gathers"),
)


COLUMN_SUMS = "norm backward column sums (kernels 8, 11, 13)"  # TRAIN_CATEGORIES' category of ptt::column_sum_kernel
# the norm kernels whose in-step time per launch stands beside their cold time per call: kernel -> (launch
# counter, profile categories, the profile whose step runs the kernel phase's shape: its reading is the one
# compared); a norm backward's column sum joins it where it is the profile's only user
NORM_IN_STEP = {
    "B": ("embed_rms", ("embed_rms (kernel B)",), "profile"),
    "C": ("rms_residual", ("rms_residual (kernel C)",), "profile"),
    "7": ("rms_norm_fwd", ("rmsnorm (kernel 7)", "rmsnorm fwd (kernel 7)"), "train_profile"),
    "8": ("rms_norm_bwd", ("rmsnorm bwd (kernel 8)", COLUMN_SUMS), "train_profile"),
    "9": ("rope_fwd", ("rope fwd (kernel 9)",), "train_profile"),
    "10": ("rope_bwd", ("rope adjoint (kernel 10)",), "train_profile"),
    "12": ("ln_residual", ("LN-residual fwd (kernel 12)",), "train_gpt_profile"),
    "13": ("ln_residual_bwd", ("LN-residual bwd (kernel 13)", COLUMN_SUMS), "train_gpt_profile"),
}
KERNEL_RECORDS: dict = {}  # the kernel phase's records (each kernel's cold ms per call), set by main
IN_STEP_READINGS: dict = {}  # kernel -> the in-step readings of every profile that launched it


def norm_in_step(by_cat_ms: dict, launches: dict, label: str) -> dict:
    """Each :data:`NORM_IN_STEP` kernel that the profiled window launched:
    its device ms per launch in the window (its categories' ms over its own
    launch counter). In the profile whose step runs the kernel phase's
    shape, beside its cold-L2 ms per call from the kernel phase and its
    bound (both from ``KERNEL_RECORDS``), and kept in ``IN_STEP_READINGS``
    for the run's ``norm_in_step_vs_cold`` line."""
    out = {}
    col_users = [n for n in ("rms_norm_bwd", "ln_residual_bwd", "rms_residual_bwd") if launches.get(n)]
    for kernel, (counter, cats, ref) in NORM_IN_STEP.items():
        n = launches.get(counter, 0)
        if not n:
            continue
        ms = sum(by_cat_ms.get(c, 0.0) for c in cats if c != COLUMN_SUMS)
        col = by_cat_ms.get(COLUMN_SUMS, 0.0) if COLUMN_SUMS in cats and col_users == [counter] else 0.0
        r = {"profile": label, "launches": n, "in_step_ms_per_launch": (ms + col) / n,
             "column_sum_ms_per_launch": col / n}
        rec = KERNEL_RECORDS.get(counter, {})
        if label == ref and rec.get("bound_ms"):
            r.update(cold_ms_per_call=rec["ms"], bound_ms=rec["bound_ms"],
                     in_step_share_of_bound=rec["bound_ms"] / r["in_step_ms_per_launch"],
                     cold_share_of_bound=rec["bound_ms"] / rec["ms"])
            IN_STEP_READINGS[kernel] = r
        out[kernel] = r
    return out


def profile_steps(eng, prompts, card: dict, warm: int = 3, steps: int = 3, label: str = "profile") -> None:
    """Where a serving step's time goes: :func:`profile_window` over
    ``steps`` engine steps (after ``warm`` unprofiled ones) on a fresh set
    of requests. The engine is drained afterwards."""
    for p in prompts:
        eng.add_request(p, max_new_tokens=32)
    for _ in range(warm):
        eng.step()
    profile_window(eng.step, steps, label, card)
    eng.run()


def profile_window(step, steps: int, label: str, card: dict) -> None:
    """``torch.profiler`` over ``steps`` calls of ``step()``: device time by
    kernel category, the device-busy time (the union of kernel intervals),
    the device's idle share of the wall time, the host's kernel launches
    and syncs a step, and the norm kernels' in-step ms per launch
    (:func:`norm_in_step`, the launch counters reset just before)."""
    from paddle_tpu_torch.kernels.select import launch_counts, reset_launch_counts

    def window():
        reset_launch_counts()
        for _ in range(steps):
            step()

    prof, wall_us = traced(window)
    launches = launch_counts()
    spans, by_cat, by_name = [], {}, {}
    for e in cuda_events(prof):
        start, dur = e.time_range.start, e.time_range.elapsed_us()
        spans.append((start, start + dur))
        cat = next((c for key, c in KERNEL_CATEGORIES if key in e.name), "elementwise / other")
        by_cat[cat] = by_cat.get(cat, 0.0) + dur
        by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + dur
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):  # union of kernel intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # the host's CUDA runtime calls a step: launches and syncs, with their CPU ms
    runtime = {e.key: {"calls": e.count / steps, "cpu_ms": e.cpu_time_total / steps / 1e3}
               for e in prof.key_averages()
               if e.key in ("cudaLaunchKernel", "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync")}
    emit({"phase": label, "steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
          "host_runtime_calls_per_step": runtime,
          "device_busy_ms_per_step": busy / steps / 1e3,
          "device_idle_share": (1 - busy / wall_us) if spans else None,
          "device_ms_per_step_by_category": {k: v / steps / 1e3 for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1])},
          "top_kernels_ms_per_step": {k: v / steps / 1e3 for k, v in top},
          "norm_in_step_vs_cold": norm_in_step({k: v / 1e3 for k, v in by_cat.items()}, launches, label),
          "cuda_events": len(spans), "kernels_per_step": len(spans) / steps, "card": card})


def profile_decode(model, ids, card: dict, steps: int = 5) -> None:
    """Where a ``generate_paged`` decode step's time goes: its model call
    (4-tuple pasts over pools prefilled from ``ids``, then the greedy
    argmax) under :func:`profile_window`, after 2 unprofiled steps."""
    import torch
    from paddle_tpu_torch.incubate.nn.functional import block_cache_prefill

    cfg = model.config
    b, prompt = ids.shape
    per = -(-(prompt + steps + 2) // 16)
    hd = cfg.hidden_size // cfg.num_attention_heads
    tables = torch.arange(b * per, dtype=torch.int32, device=ids.device).reshape(b, per)
    state = {"lens": torch.full((b,), prompt, dtype=torch.int32, device=ids.device)}
    with torch.inference_mode():
        logits, dense = model(ids, use_cache=True)
        pools = []
        for k, v in dense:
            kc = torch.zeros((b * per, cfg.num_key_value_heads, 16, hd), dtype=model.dtype, device=ids.device)
            pools.append(block_cache_prefill(kc, torch.zeros_like(kc), k, v, tables, state["lens"]))
        state["tok"] = logits[:, -1].float().argmax(-1).to(torch.int32)
        del dense, logits

    @torch.inference_mode()
    def step():
        lens = state["lens"]
        out, _ = model(state["tok"][:, None], past_key_values=[(kc, vc, tables, lens) for kc, vc in pools],
                       use_cache=True, cache_position=lens)
        state["tok"] = out[:, -1].float().argmax(-1).to(torch.int32)
        state["lens"] = lens + 1

    step()
    step()
    profile_window(step, steps, "profile_decode", card)


SERVE_ENGINE = dict(max_slots=8, block_size=16, prefill_chunk=64, max_model_len=2048, prompt_bucket=512)


def serve_prompts(vocab: int):
    """The 16 seeded requests of the serve phases: prompts of 64-512 tokens."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, int(n)) for n in rng.integers(64, 513, 16)]


def drive_engine(eng, prompts) -> dict:
    """Queue every prompt (32 new tokens each) and step the engine dry, each
    step timed on the host clock (the step ends in the host reading its
    tokens back, a device sync). The launch counters are reset just before
    and read just after."""
    import numpy as np
    from paddle_tpu_torch.kernels.select import launch_counts, reset_launch_counts

    reset_launch_counts()
    t_run = time.perf_counter()
    ids = [eng.add_request(p, max_new_tokens=32) for p in prompts]
    done, prefill_ms, decode_ms = {}, [], []
    while eng.has_work():
        before = eng.stats["prompt_tokens_computed"]
        t = time.perf_counter()
        for req in eng.step():
            done[req.req_id] = req
        dt = (time.perf_counter() - t) * 1e3
        (prefill_ms if eng.stats["prompt_tokens_computed"] > before else decode_ms).append(dt)
    run_s = time.perf_counter() - t_run
    counts = launch_counts()
    gen_tokens = sum(len(r.generated) for r in done.values())
    ttft = sorted(r.admit_time - r.arrival_time for r in done.values())
    stats = {
        "requests": len(prompts), "finished": len(done), "prompt_tokens": int(sum(p.size for p in prompts)),
        "generated_tokens": gen_tokens, "steps": eng.stats["steps"], "prefill_steps": len(prefill_ms),
        "decode_only_steps": len(decode_ms), "run_s": run_s, "decode_tokens_per_s": gen_tokens / run_s,
        "step_ms_p50": float(np.median(prefill_ms + decode_ms)),
        "prefill_step_ms_p50": float(np.median(prefill_ms)) if prefill_ms else None,
        "decode_step_ms_p50": float(np.median(decode_ms)) if decode_ms else None,
        "ttft_ms_p50": float(np.median(ttft)) * 1e3, "ttft_ms_max": ttft[-1] * 1e3,
    }
    streams = [list(done[i].generated) if i in done else None for i in ids]
    return {"stats": stats, "counts": counts, "streams": streams, "done": done}


def check_served(run: dict, eng, want: dict, label: str) -> None:
    """Every request finished with 32 tokens, the launch counts are ``want``
    for every kernel (per step times the steps), the pool drained."""
    from paddle_tpu_torch.kernels.select import KERNELS

    steps = run["stats"]["steps"]
    if run["stats"]["finished"] != run["stats"]["requests"] or any(len(s or ()) != 32 for s in run["streams"]):
        fail(f"{label}: not every request finished with 32 tokens")
    expect = {name: want.get(name, 0) * steps for name in KERNELS}
    if run["counts"] != expect:
        fail(f"{label}: launch counts {run['counts']} != {expect} for {steps} steps")
    pool = eng.pool_stats()
    if pool["free"] != pool["total"]:
        fail(f"{label}: the pool did not drain: {pool}")


def serve(dev, card: dict):
    """Phase 4: Llama-2-7B through the engine; returns the model, the launch
    counts of the timed run and its token streams."""
    import torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg = LlamaConfig.llama2_7b()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    eng = ContinuousBatchingEngine(model, **SERVE_ENGINE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompts = serve_prompts(cfg.vocab_size)
    run = drive_engine(eng, prompts)
    emit({"phase": "serve", "model": "llama2_7b (seeded random bf16 weights)", **run["stats"],
          "setup_s": setup_s, "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
          "launches": run["counts"], "pool": eng.pool_stats(), "card": card})
    layers = cfg.num_hidden_layers  # 32: A once per layer, C twice per layer, B once per step
    check_served(run, eng, {"paged_chunk_fused": layers, "embed_rms": 1, "rms_residual": 2 * layers}, "serve")
    profile_steps(eng, prompts[:8], card)
    if eng.pool_stats()["free"] != eng.pool_stats()["total"]:
        fail("the pool did not drain after the profiled steps")
    return model, run["counts"], run["streams"]


def serve_unfused(model, dev, card: dict, fused_streams) -> dict:
    """Phase 4b: the same 16 requests through a second engine with
    ``FLAGS_use_fused_decode_layer=False`` (restored afterwards): the layer
    modules, attention through kernel 4 (32x a step), every RMSNorm through
    kernel 7 (65x a step), none of A, B, C. One mixed step's logits must
    pass :func:`check_logits`' gate. The token agreement with the fused
    engine's streams is reported, not gated (bf16 paths that round
    differently part ways on near ties). Returns the launch counts."""
    import numpy as np
    import paddle_tpu_torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine

    cfg = model.config
    paddle_tpu_torch.set_flags({"FLAGS_use_fused_decode_layer": False})
    try:
        eng = ContinuousBatchingEngine(model, **SERVE_ENGINE)
        run = drive_engine(eng, serve_prompts(cfg.vocab_size))
        layers = cfg.num_hidden_layers
        agree = [float(np.mean(np.array(a) == np.array(b))) for a, b in zip(run["streams"], fused_streams)]
        emit({"phase": "serve_unfused", "flag": "FLAGS_use_fused_decode_layer=False", **run["stats"],
              "token_agreement_with_fused_mean": float(np.mean(agree)),
              "streams_identical_to_fused": sum(a == 1.0 for a in agree), "launches": run["counts"],
              "card": card})
        check_served(run, eng, {"paged_chunk": layers, "rms_norm_fwd": 2 * layers + 1}, "serve_unfused")
        profile_steps(eng, serve_prompts(cfg.vocab_size)[:8], card, label="profile_unfused")
        del eng
        check_logits(model, dev, card, label="logits_unfused")
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_use_fused_decode_layer": True})
    return run["counts"]


# -- the int8 serving path ---------------------------------------------------------

INT8_SOURCES = {
    "wo_matmul": "paddle_tpu_torch/kernels/csrc/wo_matmul.cu",
    "paged_chunk_fused_int8": "paddle_tpu_torch/kernels/csrc/paged_chunk_fused.cu",
    "paged_chunk_int8": "paddle_tpu_torch/kernels/csrc/paged_chunk_fused.cu",
    "paged_decode_int8": "paddle_tpu_torch/kernels/csrc/paged_decode.cu",
    "paged_decode_fused_int8": "paddle_tpu_torch/kernels/csrc/paged_decode.cu",
    "flxent_fwd_int8": "paddle_tpu_torch/kernels/csrc/flxent_int8.cu",  # the train shape's wgmma route
}
# the serving step's projections at 8 slots x 64 rows: gate/up, down, lm head
WO_SHAPES = {"gate_up": (512, 4096, 11008), "down": (512, 11008, 4096), "lm_head": (512, 4096, 32000)}


def wo_case(dev, gen, m: int, k: int, n: int, dtype, label: str, card: dict, timed: bool = False) -> dict:
    """Kernel 20 against its plain version on x ~ N(0, 1) and a weight
    quantized from N(0, 0.02), on the instance ``wo_route`` names. bf16 and
    fp16: the same fp32 products summed in another order, each output
    rounded once to x's type, so within one ulp of the type plus 1e-4 for
    values near 0. fp32 (the mma.sync instance, two TF32 passes of x split
    into hi + lo, against the plain fp32 product with TF32 off): the
    products miss the fp32 ones by ~2^-22 of their magnitude and the sums
    run in other orders, so within 2^-16 of the sum of the products'
    magnitudes, ``(|x| @ |w8|) * scale`` (a dropped product costs ~2^-12 of
    it at K 4096; one TF32 pass misses by ~2^-11 of each product), plus
    1e-6. Each case prints its worst error over its limit. With ``timed``
    its time and one PyTorch call's (medians of :data:`WO_PAIRS` readings
    taken in turns, with the median and the spread of the paired ratios),
    the plain version's time, ``x @ W`` with the
    unquantized weight in x's type (cuBLAS: the projection it stands in
    for), and its share of the bound (bytes, or operations at the type's
    peak; fp32: two TF32 passes at the TF32 tensor peak, the 67 TFLOP/s
    one-pass bound beside it)."""
    import torch
    from paddle_tpu_torch.kernels.quant import (int8_weight_matmul, int8_weight_matmul_plain, quantize_weight_int8,
                                                wo_route)

    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    w = 0.02 * torch.randn((k, n), generator=gen, device=dev)
    w8, scale = quantize_weight_int8(w)
    got, want = int8_weight_matmul(x, w8, scale), int8_weight_matmul_plain(x, w8, scale)
    torch.cuda.synchronize()
    route = wo_route(dtype, m, k, n)
    if dtype == torch.float32:
        mag = (x.abs() @ w8.abs().float()) * scale[None, :]
        err_t = (got - want).abs()
        limit = 2.0 ** -16 * mag + 1e-6
        err, ok = float(err_t.max()), bool((err_t <= limit).all())
        worst = float((err_t / limit).max())
        tol = "2^-16 * (|x| @ |w8|) * scale + 1e-6"
        del mag, err_t, limit
    else:
        ulp = {torch.bfloat16: BF16_REL, torch.float16: 2.0 ** -10}[dtype]
        err, ok = within(got, want, atol=1e-4, rel=ulp)
        worst = float(((got.float() - want.float()).abs()
                       / (1e-4 + ulp * torch.maximum(got.float().abs(), want.float().abs()))).max())
        tol = f"1e-4 + {ulp}*|x|"
    line = {"phase": "kernel_check", "kernel": "wo_matmul", "case": label, "route": route,
            "shape": {"x": [m, k], "w8": [k, n]}, "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
            "worst_err_over_limit": worst, "tolerance": tol}
    if not ok or got.dtype != dtype or not bool(torch.isfinite(got).all()):
        emit({**line, "card": card})
        fail(f"wo_matmul disagrees with its plain version ({label}): max abs err {err}")
    res = {"max_abs_err": err, "route": route, "worst_err_over_limit": worst}
    if timed:
        wd = w.to(dtype)
        run, run_plain = (lambda: int8_weight_matmul(x, w8, scale)), (lambda: int8_weight_matmul_plain(x, w8, scale))
        nbytes = m * k * x.element_size() + k * n + 4 * n + m * n * x.element_size()
        if dtype == torch.float32:  # two TF32 passes on the tensor cores; one pass at fp32's CUDA-core peak beside
            cost = {**bound(nbytes, 2 * 2.0 * m * k * n, TF32_FLOP_PER_S),
                    "bound_ms_cuda_cores": bound(nbytes, 2.0 * m * k * n, FP32_FLOP_PER_S)["bound_ms"]}
        else:
            cost = bound(nbytes, 2.0 * m * k * n, BF16_FLOP_PER_S)
        # WO_PAIRS readings of the kernel and the library taken in turns: ms and library_ms are their medians,
        # vs_library the median of the paired ratios (the gates read it), the ratios' spread beside it
        pairs = [(device_ms(run), device_ms(lambda: torch.matmul(x, wd))) for _ in range(WO_PAIRS)]
        ratios = sorted(a / b for a, b in pairs)
        res.update(ms=statistics.median(a for a, _ in pairs), plain_ms=device_ms(run_plain, iters=5),
                   call_ms=call_ms(run), library_ms=statistics.median(b for _, b in pairs), **cost)
        res.update(share_of_bound=res["bound_ms"] / res["ms"], vs_library=statistics.median(ratios),
                   vs_library_spread=[ratios[0], ratios[-1]])
        line.update({kk: res[kk] for kk in ("ms", "plain_ms", "call_ms", "library_ms", "bound_ms", "bound_by",
                                            "share_of_bound", "vs_library", "vs_library_spread")})
        if "bound_ms_cuda_cores" in res:
            line["bound_ms_cuda_cores"] = res["bound_ms_cuda_cores"]
        line["library"] = "torch.matmul(x, W) with the unquantized weight in x's dtype (cuBLAS)"
    emit({**line, "card": card})
    return res


WO_PAIRS = 7  # a timed case's paired readings of kernel 20 and its library product
WO_GATE = 1.25  # kernel 20 at most this times cuBLAS's bf16 x @ W at each serving shape, in the same call
# kernel 20's mma.sync instance at most this times the library's product in x's type, in the same call (the
# median of WO_PAIRS paired ratios): fp32 gate/up against torch.matmul in fp32 with TF32 off, the ragged bf16
# head against cuBLAS's bf16 x @ W
WO_MMA_GATE = 1.0
WO_RAGGED = (77, 4100, 32003)  # K % 8 and N % 16 both non-zero (an odd vocabulary): the mma.sync route in any type


def check_wo_matmul(dev, gen, card: dict) -> dict:
    """Kernel 20 at the step's three projection shapes in bf16, timed beside
    cuBLAS's bf16 ``x @ W`` and gated at :data:`WO_GATE` times it; eight
    rows at gate/up (a decode batch: the weight's bytes bound it), and fp32
    at gate/up beside ``torch.matmul`` in fp32 with TF32 off, both timed;
    ``[77, 4100] x [4100, 32003]`` (:data:`WO_RAGGED`: K % 8 and N % 16
    both non-zero) in bf16 beside cuBLAS's bf16 product and in fp32 beside
    ``torch.matmul`` in fp32 with TF32 off, timed; the mma.sync instance
    (every fp32 case and the ragged ones) gated at :data:`WO_MMA_GATE` x its
    library at fp32 gate/up and the ragged bf16 head; checked only: fp16
    ragged rows (wgmma) and the ragged head in fp16, one row in bf16 and in
    fp32, eight fp32 rows, x rows 2-byte aligned (K 4099) and W rows
    1-byte aligned (N 1001), and the eval loss's 4096 rows. Each case's
    worst error over its limit is printed. Returns the timed cases."""
    import torch

    shapes = {label: wo_case(dev, gen, m, k, n, torch.bfloat16, label, card, timed=True)
              for label, (m, k, n) in WO_SHAPES.items()}
    shapes["eight_rows"] = wo_case(dev, gen, 8, 4096, 11008, torch.bfloat16, "eight rows", card, timed=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        shapes["fp32_gate_up"] = wo_case(dev, gen, 512, 4096, 11008, torch.float32, "fp32, gate/up", card, timed=True)
        shapes["fp32_ragged"] = wo_case(dev, gen, *WO_RAGGED, torch.float32, "fp32, ragged K and N", card, timed=True)
        checked = {"fp32 one row": wo_case(dev, gen, 1, 4096, 11008, torch.float32, "fp32, one row", card),
                   "fp32 eight rows": wo_case(dev, gen, 8, 4096, 11008, torch.float32, "fp32, eight rows", card),
                   "fp32 N 1001": wo_case(dev, gen, 130, 1024, 1001, torch.float32, "fp32, W rows 1-byte aligned",
                                          card)}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    checked["fp16 ragged rows"] = wo_case(dev, gen, 77, 320, 208, torch.float16, "fp16, ragged rows", card)
    checked["one row"] = wo_case(dev, gen, 1, 4096, 11008, torch.bfloat16, "one row", card)
    shapes["ragged_bf16"] = wo_case(dev, gen, *WO_RAGGED, torch.bfloat16, "ragged K and N (mma_sync route)", card,
                                    timed=True)
    checked["fp16 ragged K and N"] = wo_case(dev, gen, *WO_RAGGED, torch.float16, "fp16, ragged K and N", card)
    checked["bf16 K 4099"] = wo_case(dev, gen, 5, 4099, 1024, torch.bfloat16, "bf16, x rows 2-byte aligned", card)
    checked["eval rows"] = wo_case(dev, gen, 4096, 4096, 11008, torch.bfloat16, "eval rows (M 4096)", card)
    ratios = {label: shapes[label]["vs_library"] for label in WO_SHAPES}
    mma_ratios = {label: shapes[label]["vs_library"] for label in ("fp32_gate_up", "ragged_bf16", "fp32_ragged")}
    emit({"phase": "wo_matmul_gate", "ms_over_cublas_bf16": ratios, "limit": WO_GATE,
          "mma_sync_over_library": mma_ratios, "mma_sync_limit": WO_MMA_GATE, "paired_readings": WO_PAIRS,
          "spread_over_library": {label: r["vs_library_spread"] for label, r in shapes.items()},
          "mma_sync_gated": ["fp32_gate_up", "ragged_bf16"],
          "library": {"fp32_gate_up": "torch.matmul fp32, TF32 off", "fp32_ragged": "torch.matmul fp32, TF32 off",
                      "ragged_bf16": "cuBLAS bf16 x @ W"},
          "share_of_bound": {label: r["share_of_bound"] for label, r in shapes.items()},
          "bound_ms_cuda_cores": {label: r["bound_ms_cuda_cores"] for label, r in shapes.items()
                                  if "bound_ms_cuda_cores" in r},
          "worst_err_over_limit": {**{label: r["worst_err_over_limit"] for label, r in shapes.items()},
                                   **{label: r["worst_err_over_limit"] for label, r in checked.items()}},
          "routes": {label: r["route"] for label, r in {**shapes, **checked}.items()}, "card": card})
    slow = {label: r for label, r in ratios.items() if r > WO_GATE}
    if slow:
        fail(f"wo_matmul is slower than {WO_GATE}x cuBLAS's bf16 x @ W at {slow}")
    slow = {label: mma_ratios[label] for label in ("fp32_gate_up", "ragged_bf16") if mma_ratios[label] > WO_MMA_GATE}
    if slow:
        fail(f"wo_matmul's mma.sync instance is slower than {WO_MMA_GATE}x its library product at {slow}")
    return shapes


def int8_pool(args: dict) -> dict:
    """``args`` with its K/V pools quantized per token (the engine's int8
    pool: int8 payload, fp32 ``k_scale`` / ``v_scale`` planes)."""
    from paddle_tpu_torch.incubate.nn.functional.block_attention import _quantize_kv_rows

    k8, ks = _quantize_kv_rows(args["key_cache"])
    v8, vs = _quantize_kv_rows(args["value_cache"])
    return {**args, "key_cache": k8, "value_cache": v8, "k_scale": ks, "v_scale": vs}


def dequant_gathered(args: dict, n_pos):
    """The int8 pool's K and V of each slot's first ``n_pos`` positions,
    dequantized into q's dtype and gathered dense (the SDPA yardstick's
    operands)."""
    kd, vd, L = gathered_kv({**args, "key_cache": args["key_cache"].float() * args["k_scale"][..., None],
                             "value_cache": args["value_cache"].float() * args["v_scale"][..., None]}, n_pos)
    return kd.to(args["q"].dtype), vd.to(args["q"].dtype), L


def check_int8_paged(dev, gen, card: dict, records: dict) -> None:
    """Kernels A, 4, 5 and 6 over int8 pools (``check_paged_new``'s 7B
    batches, quantized per token) against their plain versions, with q in
    bf16, fp16 and fp32 at the 7B MHA geometry and in bf16 at GQA 32/8:
    both sides dequantize to the same fp32 values, so the tolerance is the
    bf16 pools' by q's dtype. Timed in bf16 at the 7B geometry, with SDPA
    over the gathered, dequantized K/V as the library yardstick."""
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.kernels import paged_attention as kp

    for dtype, hq, hkv in ((torch.bfloat16, 32, 32), (torch.bfloat16, 32, 8), (torch.float16, 32, 32),
                           (torch.float32, 32, 32)):
        name = str(dtype).split(".")[-1]
        atol, rel = PAGED_TOL[name]
        args, used = paged_batch(dev, gen, hq, hkv, dtype=dtype)
        args = int8_pool(args)
        cargs = {k: v for k, v in args.items() if k not in ("cos", "sin")}
        dargs, _ = decode_batch(dev, gen, hq, hkv, dtype=dtype)
        dargs = int8_pool(dargs)
        pargs = {k: v for k, v in dargs.items() if k not in ("cos", "sin")}
        pairs = {
            "paged_chunk_fused_int8": (lambda: kp.paged_flash_chunk_fused(**args),
                                       lambda: kp.paged_flash_chunk_fused_plain(**args)),
            "paged_chunk_int8": (lambda: kp.paged_flash_chunk(**cargs), lambda: kp.paged_flash_chunk_plain(**cargs)),
            "paged_decode_int8": (lambda: kp.paged_flash_decode(**pargs), lambda: kp.paged_flash_decode_plain(**pargs)),
            "paged_decode_fused_int8": (lambda: kp.paged_flash_decode_fused(**dargs),
                                        lambda: kp.paged_flash_decode_fused_plain(**dargs)),
        }
        errs = {}
        for k, (run, run_plain) in pairs.items():
            g, w = run(), run_plain()
            torch.cuda.synchronize()
            errs[k], ok = within(g, w, atol=atol, rel=rel)
            zero = bool((g[6] == 0).all())
            if not ok or not zero or g.dtype != dtype:
                fail(f"{k} in {name} at HQ={hq} HKV={hkv} disagrees with its plain version "
                     f"(max abs err {errs[k]}, idle slot zero {zero}, dtype {g.dtype})")
        emit({"phase": "kernel_check", "kernel": "paged A/4/5/6 over the int8 pool", "dtype": name, "hq": hq,
              "hkv": hkv, "max_abs_err": errs, "tolerance": f"{atol} + {rel}*|x|", "card": card})
        if not (dtype == torch.bfloat16 and hq == hkv):
            continue
        b, c, _, d = args["q"].shape
        ends = [int(n) + int(m) for n, m in zip(args["seq_lens"], args["q_lens"])]
        kd, vd, L = dequant_gathered(args, ends)
        pos = torch.arange(L, device=dev)
        cmask = (pos[None, None, :] < (args["seq_lens"][:, None] + torch.arange(c, device=dev)[None] + 1)[:, :, None])[:, None]
        qt = args["q"].transpose(1, 2)
        qr = kp.rope_rows(args["q"], args["cos"][:, :, None], args["sin"][:, :, None]).transpose(1, 2)
        dl = [int(n) for n in dargs["seq_lens"]]
        kd1, vd1, L1 = dequant_gathered(dargs, dl)
        dmask = (torch.arange(L1, device=dev)[None, :] < dargs["seq_lens"][:, None])[:, None, None]
        qd = dargs["q"][:, :, None]
        qdr = kp.rope_rows(dargs["q"], dargs["cos"], dargs["sin"])[:, :, None]
        # the scale planes: one fp32 per used row and KV head, K and V
        chunk_scales, decode_scales = 2 * hkv * 4 * sum(e for e, m in zip(ends, args["q_lens"]) if m), 2 * hkv * 4 * sum(dl)
        libs = {
            "paged_chunk_fused_int8": (lambda: tF.scaled_dot_product_attention(qr, kd, vd, attn_mask=cmask),
                                       paged_cost(args), chunk_scales),
            "paged_chunk_int8": (lambda: tF.scaled_dot_product_attention(qt, kd, vd, attn_mask=cmask),
                                 paged_cost(args, rope=False), chunk_scales),
            "paged_decode_int8": (lambda: tF.scaled_dot_product_attention(qd, kd1, vd1, attn_mask=dmask),
                                  decode_cost(dargs, rope=False), decode_scales),
            "paged_decode_fused_int8": (lambda: tF.scaled_dot_product_attention(qdr, kd1, vd1, attn_mask=dmask),
                                        decode_cost(dargs), decode_scales),
        }
        for k, (run_lib, (nbytes, flops), sbytes) in libs.items():
            run, run_plain = pairs[k]
            records[k] = dict(source=INT8_SOURCES[k], max_abs_err=errs[k], ms=device_ms(run),
                              plain_ms=device_ms(run_plain, iters=5), library_ms=device_ms(run_lib),
                              call_ms=call_ms(run), **bound(nbytes + sbytes, flops))
            emit({"phase": "kernel_check", "kernel": k, "hq": hq, "hkv": hkv, "bytes": nbytes + sbytes,
                  "flops": flops, "library": "SDPA over the gathered K/V, dequantized to bf16",
                  **records[k], "card": card})
        del kd, vd, kd1, vd1


def widen_times(w8, vocab_major: bool, vc: int) -> dict:
    """The widen pass (``int8_plane``) on the int8 W's first ``vc`` columns:
    its time, its plain version's (``.float()`` of the block, then
    ``.contiguous()``), PyTorch's one call for the same K-major fp32 plane
    (``W[:, :vc].t().to(float32, memory_format=contiguous_format)``, or
    ``W[:vc].to(float32)`` when vocab-major: the library reading, which must
    give the same bits) and the bound (the int8 values read once, written
    once as fp32)."""
    import torch
    from paddle_tpu_torch.kernels import fused_loss as kl

    h = w8.shape[1] if vocab_major else w8.shape[0]
    if vocab_major:
        lib = lambda: w8[:vc].to(torch.float32)  # noqa: E731
    else:
        lib = lambda: w8[:, :vc].t().to(torch.float32, memory_format=torch.contiguous_format)  # noqa: E731
    run = lambda: kl.int8_plane(w8, vocab_major, 0, vc)  # noqa: E731
    got, want = run(), lib()
    if not (want.is_contiguous() and torch.equal(got, want)):
        fail(f"the widen pass and its library call disagree (vocab_major={vocab_major})")
    del got, want
    res = dict(ms=device_ms(run, iters=10), call_ms=call_ms(run, iters=10),
               plain_ms=device_ms(lambda: kl.int8_plane_plain(w8, vocab_major, 0, vc), iters=3),
               library_ms=device_ms(lib, iters=10), vocab_major=vocab_major,
               what=f"one sub-chunk: W's first {vc} columns into their fp32 plane [{vc}, {h}]",
               library=("W[:vc].to(float32)" if vocab_major
                        else "W[:, :vc].t().to(float32, memory_format=contiguous_format)"),
               **bound(vc * h * 5, 0.0))
    res["share_of_bound"] = res["bound_ms"] / res["ms"]
    res["vs_library"] = res["ms"] / res["library_ms"]
    return res


def flxent_int8_case(dev, gen, n: int, h: int, v: int, dtype, vocab_major: bool, label: str, card: dict,
                     route_want: str, timed: bool = False) -> dict:
    """Kernel 17's int8 site against its plain version on the route
    ``flx_int8_route_of`` names (printed; it must be ``route_want``): lse
    and tl within 1e-4 of max(1, |v|) in bf16 / fp16 (fp32 sums in another
    order, as for kernel 17), in fp32 under :func:`fp32_fwd_gate` (the
    plain version run with TF32 off by the caller; with TF32 on it must fail
    the gate), and two calls the same bits; on ``"tf32x2"`` the widen pass
    bitwise against its plain version (W's first and last sub-chunks). W is quantized
    from N(0, 0.02) per vocab column. With ``timed`` its time, the plain
    version's and the head's two library calls (cuBLAS ``x @ W`` with the
    dequantized weight in x's dtype, then ``F.cross_entropy``; in fp32 with
    TF32 off, as the caller sets it), beside its bound at the rate of x's
    type (``"tf32x2"``: two TF32 passes at the TF32 peak), and on
    ``"tf32x2"`` the widen pass's time (W's first sub-chunk, in this case's
    layout and in the other) beside its bound and PyTorch's one call for the
    same plane (:func:`widen_times`)."""
    import torch
    from paddle_tpu_torch.kernels import fused_loss as kl
    from paddle_tpu_torch.kernels.quant import quantize_weight_int8
    from paddle_tpu_torch.nn.functional import cross_entropy

    x, w, lab, _ = flxent_inputs(dev, gen, n, h, v, torch.float32, vocab_major)
    x = x.to(dtype)
    w8, scale = quantize_weight_int8(w.t() if vocab_major else w)  # per vocab column of [H, V]
    w8 = w8.t().contiguous() if vocab_major else w8
    del w
    route = kl.flx_int8_route_of(x, w8, vocab_major)
    if route != route_want:
        fail(f"flxent_fwd_int8 ({label}): the route is {route}, not {route_want}")
    lse, tl = kl.flxent_fwd_int8(x, w8, scale, lab, vocab_major)
    lse2, tl2 = kl.flxent_fwd_int8(x, w8, scale, lab, vocab_major)
    lse_p, tl_p = kl.flxent_fwd_int8_plain(x, w8, scale, lab, vocab_major)
    torch.cuda.synchronize()
    err, ok, readings = {}, True, {}
    for name, got, want in (("lse", lse, lse_p), ("tl", tl, tl_p)):
        d = (got - want).abs()
        err[name] = float(d.max())
        ok = ok and bool((d <= 1e-4 * want.abs().clamp(min=1.0)).all())
    if dtype == torch.float32:  # the fp32 forward's gate, and its TF32 control
        readings = fp32_fwd_readings(x, w8, lab, lse, tl, lse_p, tl_p, vocab_major, scale)
        ok = readings["lse"].pop("ok") and readings["tl"].pop("ok") and not readings["tf32 control"].pop("ok")
    widen = None
    if route == "tf32x2":  # the widen pass against its plain version, bitwise: W's first and last sub-chunks
        vc = min(kl.flx_fwd_sub(n, h, v, 2), v)
        widen = {"same_bits": True, "max_abs_err": 0.0}
        for c0, c1 in ((0, vc), ((v - 1) // vc * vc, v)):
            got, want = kl.int8_plane(w8, vocab_major, c0, c1), kl.int8_plane_plain(w8, vocab_major, c0, c1)
            widen["same_bits"] = widen["same_bits"] and bool(torch.equal(got, want))
            widen["max_abs_err"] = max(widen["max_abs_err"], float((got - want).abs().max()))
            del got, want
        ok = ok and widen["same_bits"]
    same = bool(torch.equal(lse, lse2)) and bool(torch.equal(tl, tl2))
    line = {"phase": "kernel_check", "kernel": "flxent_fwd_int8", "case": label, "route": route,
            "shape": {"x": [n, h], "w8": list(w8.shape), "vocab_major": vocab_major},
            "dtype": str(dtype).split(".")[-1], "max_err": err, "two_calls_same_bits": same,
            "tolerance": ("1e-4 * max(1, |v|) in bf16 / fp16; fp32: " + FLX_FWD_FP32_TOL
                          + "; two calls the same bits; the widen pass bitwise")}
    if readings:
        line["gate_readings"] = readings
    if widen:
        line["widen_pass"] = widen
    if not (ok and same):
        emit({**line, "card": card})
        fail(f"flxent_fwd_int8 disagrees with its plain version or itself ({label}): {err}, same bits {same}, "
             f"gate {readings}, widen pass {widen}")
    res = {"max_abs_err": max(err.values()), "route": route}
    if widen:
        res["widen_max_abs_err"] = widen["max_abs_err"]
    if timed:
        wd = ((w8.t() if vocab_major else w8).float() * scale[None, :]).to(dtype)  # [H, V], dequantized
        lab64 = lab.long().where(lab < v, torch.full_like(lab.long(), -100))
        run = lambda: kl.flxent_fwd_int8(x, w8, scale, lab, vocab_major)  # noqa: E731
        rate = FP32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
        res.update(ms=device_ms(run, iters=10), call_ms=call_ms(run, iters=10),
                   plain_ms=device_ms(lambda: kl.flxent_fwd_int8_plain(x, w8, scale, lab, vocab_major), iters=2,
                                      warmup=1),
                   library_ms=device_ms(lambda: cross_entropy(x @ wd, lab64, ignore_index=-100), iters=5),
                   **bound(n * h * x.element_size() + v * h + 4 * v + 3 * n * 4, 2.0 * n * h * v, rate))
        if route == "tf32x2":  # two TF32 passes at the TF32 tensor peak (the bound above: one pass at 67 TFLOP/s)
            res["bound_ms_67_tflops"] = res["bound_ms"]
            res.update(bound(n * h * x.element_size() + v * h + 4 * v + 3 * n * 4, 2 * 2.0 * n * h * v,
                             TF32_FLOP_PER_S))
            res["widen"] = widen_times(w8, vocab_major, vc)
            res["widen"]["other_layout"] = widen_times(w8.t().contiguous(), not vocab_major, vc)
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
        res["vs_library"] = res["ms"] / res["library_ms"]
        line.update({kk: res[kk] for kk in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                            "share_of_bound", "vs_library", "bound_ms_67_tflops", "widen")
                     if kk in res})
        line["library"] = "two calls: cuBLAS x @ W (the dequantized head in x's dtype) + F.cross_entropy"
        del wd
    emit({**line, "card": card})
    torch.cuda.empty_cache()
    return res


def check_int8_kernels(dev, gen, card: dict, records: dict) -> None:
    """The int8 serving path's kernels against their plain versions: kernel
    20 by :func:`check_wo_matmul`; A, 4, 5, 6 over int8 pools; kernel 17's
    int8 site at the loss head's shape (x ``[8192, 4096]`` bf16, W int8
    ``[4096, 32000]``: the wgmma route, timed and gated at
    :data:`FLX_INT8_GATE` times its library), on the wgmma route at ragged
    rows (1000: 256- and 128-row tiles; 40: the 64-row tiles; 5: the 8-row
    tiles) in bf16 and fp16, on the mma.sync route at V 32003, vocab-major
    and fp16 V 3001, and in fp32 on the 2xTF32 instance (vocab-major ragged,
    ``[H, V]`` ragged in rows, H and V, and x ``[2048, 4096]`` timed beside
    the fp32 library head, TF32 off, gated at :data:`FLX_INT8_FP32_GATE`
    times it; its widen pass gated at :data:`FLX_WIDEN_GATE` times
    PyTorch's one call for the same plane, in both layouts) and on the CUDA
    cores where the widen pass cannot take W (V 3001); the int8 appends
    under the sync check."""
    import torch

    bf, f16 = torch.bfloat16, torch.float16
    shapes = check_wo_matmul(dev, gen, card)
    records["wo_matmul"] = dict(source=INT8_SOURCES["wo_matmul"], shapes=shapes,
                                sources={"wgmma (bf16 / fp16, K % 8 == 0, N % 16 == 0)":
                                         "paddle_tpu_torch/kernels/csrc/wo_matmul.cu on csrc/wo_mainloop.cuh",
                                         "mma_sync (fp32; ragged K or N)": INT8_SOURCES["wo_matmul"]},
                                max_abs_err=max(r["max_abs_err"] for r in shapes.values()),
                                **{k: shapes["gate_up"][k] for k in ("ms", "plain_ms", "library_ms", "call_ms",
                                                                     "bound_ms", "bound_by")})
    check_int8_paged(dev, gen, card, records)
    head = flxent_int8_case(dev, gen, 8192, 4096, 32000, bf, False, "loss head shape", card, "wgmma", timed=True)
    flxent_int8_case(dev, gen, 1000, 1024, 5008, bf, False, "ragged rows, V 5008", card, "wgmma")
    flxent_int8_case(dev, gen, 40, 1024, 5008, f16, False, "fp16, 40 rows (64-row tiles)", card, "wgmma")
    flxent_int8_case(dev, gen, 5, 512, 3008, bf, False, "5 rows (8-row tiles), H 512", card, "wgmma")
    flxent_int8_case(dev, gen, 1000, 1024, 32003, bf, False, "ragged rows and vocab (V % 16 != 0)", card, "mma_sync")
    flxent_int8_case(dev, gen, 2048, 1024, 5000, bf, True, "vocab-major W [V, H]", card, "mma_sync")
    flxent_int8_case(dev, gen, 520, 512, 3001, f16, False, "fp16, ragged", card, "mma_sync")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        flxent_int8_case(dev, gen, 300, 256, 1000, torch.float32, True, "fp32, ragged, vocab-major", card,
                         "tf32x2")
        flxent_int8_case(dev, gen, 200, 328, 1008, torch.float32, False, "fp32, ragged [H, V] (H 328, V 1008)",
                         card, "tf32x2")
        flxent_int8_case(dev, gen, 520, 512, 3001, torch.float32, False, "fp32, ragged (V % 16 != 0)", card,
                         "cuda_cores")
        fp32 = flxent_int8_case(dev, gen, 2048, 4096, 32000, torch.float32, False, "fp32, 2048 rows", card,
                                "tf32x2", timed=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    records["flxent_fwd_int8"] = dict(source=INT8_SOURCES["flxent_fwd_int8"], **head)
    records["flxent_fwd_int8"]["fp32_2048_rows"] = {k: t for k, t in fp32.items() if k != "widen"}
    records["flxent_fwd_int8"]["sources"] = {"wgmma (bf16 / fp16, W [H, V])": INT8_SOURCES["flxent_fwd_int8"],
                                             "tf32x2 (fp32)": FLXENT_TF32_SOURCE,
                                             "mma_sync (bf16 / fp16)": "paddle_tpu_torch/kernels/csrc/flxent_fwd.cu",
                                             "cuda_cores (fp32, W the widen pass cannot take)":
                                                 "paddle_tpu_torch/kernels/csrc/flxent_fp32.cu"}
    records["flxent_widen"] = dict(source=FLXENT_TF32_SOURCE, max_abs_err=fp32["widen_max_abs_err"], **fp32["widen"])
    widen = {"[H, V]": fp32["widen"]["vs_library"], "[V, H]": fp32["widen"]["other_layout"]["vs_library"]}
    emit({"phase": "flxent_int8_gate", "ms_over_library": head["vs_library"], "limit": FLX_INT8_GATE,
          "share_of_bound": head["share_of_bound"], "fp32_2048_rows": fp32, "fp32_limit": FLX_INT8_FP32_GATE,
          "widen_over_library": widen, "widen_limit": FLX_WIDEN_GATE, "card": card})
    if head["vs_library"] > FLX_INT8_GATE:
        fail(f"kernel 17's int8 site is slower than {FLX_INT8_GATE}x its library at the train shape: "
             f"{head['vs_library']}")
    if fp32["vs_library"] > FLX_INT8_FP32_GATE:
        fail(f"kernel 17's int8 site in fp32 is slower than {FLX_INT8_FP32_GATE}x its fp32 library at x [2048, "
             f"4096]: {fp32['vs_library']}")
    if max(widen.values()) > FLX_WIDEN_GATE:
        fail(f"the widen pass is slower than {FLX_WIDEN_GATE}x PyTorch's one call for its plane: {widen}")
    check_append_sync(dev, gen, card, int8=True)


EVAL_SHAPE = (2, 2048)  # sequences, tokens


def eval_loss(model, dev, card: dict, label: str) -> tuple:
    """``model(ids, labels=labels)`` under ``torch.no_grad()`` on one seeded
    ``2 x 2048`` batch of next-token pairs (the last position ignored), the
    launch counters reset just before and read just after; returns the loss
    and the launch counts.
    On a weight-only int8 model (``eval_loss_int8``, and the fp16 / fp32
    weight-only models) the loss head is kernel 17's int8 site, launched
    twice (partials, merge) on the route ``flx_int8_route_of`` names
    (printed; on ``"tf32x2"`` one split of x, per sub-chunk of
    ``flx_fwd_sub`` columns a widen and a partials launch, then the merge),
    and the MLP kernel 20, 3 a layer; the loss must match the
    plain int8 head's on the same final hidden states within 1e-4 of
    max(1, |loss|)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels import fused_loss as kl
    from paddle_tpu_torch.kernels.select import KERNELS, launch_counts, reset_launch_counts

    cfg = model.config
    b, s = EVAL_SHAPE
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int64)).to(dev)
    labels = torch.roll(ids, -1, 1)
    labels[:, -1] = -100
    quant = model.lm_head.weight_scale is not None
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss, logits = model(ids, labels=labels)
        loss_v = float(loss)
    ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    line = {"phase": label, "batch": [b, s], "loss": loss_v, "ms": ms, "logits_returned": logits is not None,
            "launches": {n: c for n, c in counts.items() if c}, "card": card}
    if quant:
        route = kl.flx_int8_route_of(torch.empty((1, cfg.hidden_size), dtype=model.dtype, device=dev),
                                     model.lm_head.weight, False)
        line["loss_head_route"] = route
        layers = cfg.num_hidden_layers
        want = {"flxent_fwd_int8": 2, "wo_matmul": 3 * layers, "flash_fwd": layers, "rope_fwd": 2 * layers,
                "rms_norm_fwd": 2 * layers + 1}
        if route == "tf32x2":  # a split of x; per sub-chunk a widen and a partials launch; the merge
            subs = -(-cfg.vocab_size // kl.flx_fwd_sub(b * s, cfg.hidden_size, cfg.vocab_size, 2))
            want.update(flxent_fwd_int8=subs + 1, flxent_widen=subs, flxent_split=1)
        with torch.no_grad():
            h = model.llama(ids)
            plain = float(kl.linear_cross_entropy(h, model.lm_head.weight, labels.to(torch.int32), use_kernels=False,
                                                  weight_scale=model.lm_head.weight_scale))
        line.update(plain_head_loss=plain, tolerance="1e-4 * max(1, |loss|)")
        emit(line)
        if counts != {n: want.get(n, 0) for n in KERNELS}:
            fail(f"{label}: launches {counts}, want {want} and nothing else")
        if not (np.isfinite(loss_v) and abs(loss_v - plain) <= 1e-4 * max(1.0, abs(plain))):
            fail(f"{label}: loss {loss_v} vs the plain int8 head's {plain}")
    else:
        emit(line)
        if not np.isfinite(loss_v):
            fail(f"{label}: the loss is not finite")
    return loss_v, counts


def serve_int8(model, dev, card: dict, bf16_streams) -> dict:
    """``serve_int8``: the serve phase's engine configuration and 16
    requests with ``kv_cache_dtype="int8", weight_only_int8=True`` (the JAX
    engine's int8 configuration; it quantizes the model's MLP projections
    and lm head in place). Every request finishes with 32 tokens; each step
    launches kernel A's int8 instance 32x, B 1x, C 64x and kernel 20 97x (3
    projections per layer and the head) and nothing else; the pool drains;
    a profile of three steps; one step's logits through :func:`logits_gate`
    against an fp32 run of the int8 plain path. Reports the step times,
    TTFT, peak memory, ``bytes_per_token`` and the greedy-token agreement
    with the bf16 engine's streams (reported, not gated: the JAX package's
    own >= 0.99 quality gate does not hold on the CPU). Returns the launch
    counts."""
    import numpy as np
    import torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine

    cfg = model.config
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = ContinuousBatchingEngine(model, **SERVE_ENGINE, kv_cache_dtype="int8", weight_only_int8=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    run = drive_engine(eng, serve_prompts(cfg.vocab_size))
    layers = cfg.num_hidden_layers
    agree = [float(np.mean(np.array(a) == np.array(b))) for a, b in zip(run["streams"], bf16_streams)]
    emit({"phase": "serve_int8", "config": "kv_cache_dtype=int8, weight_only_int8=True", **run["stats"],
          "setup_s": setup_s, "quantized_params": len(eng._wq_params),
          "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
          "token_agreement_with_bf16_mean": float(np.mean(agree)),
          "streams_identical_to_bf16": sum(a == 1.0 for a in agree), "launches": run["counts"],
          "pool": eng.pool_stats(), "card": card})
    if len(eng._wq_params) != 3 * layers + 1 or eng.pool_stats()["bytes_per_token"] != 2 * layers * cfg.num_key_value_heads * (
            cfg.hidden_size // cfg.num_attention_heads + 4):
        fail(f"serve_int8: {len(eng._wq_params)} projections quantized, pool {eng.pool_stats()}")
    check_served(run, eng, {"paged_chunk_fused_int8": layers, "embed_rms": 1, "rms_residual": 2 * layers,
                            "wo_matmul": 3 * layers + 1}, "serve_int8")
    profile_steps(eng, serve_prompts(cfg.vocab_size)[:8], card, label="profile_int8")
    del eng
    check_logits(model, dev, card, label="logits_int8", kv_int8=True)
    return run["counts"]


def serve_int8_unfused(model, dev, card: dict) -> dict:
    """``serve_int8_unfused``: :func:`serve_int8` with
    ``FLAGS_use_fused_decode_layer=False`` (restored afterwards): each step
    launches kernel 4's int8 instance 32x, RMSNorm kernel 7 65x and kernel
    20 97x, and nothing else; its logits through the same gate. Returns the
    launch counts."""
    import paddle_tpu_torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine

    cfg = model.config
    paddle_tpu_torch.set_flags({"FLAGS_use_fused_decode_layer": False})
    try:
        eng = ContinuousBatchingEngine(model, **SERVE_ENGINE, kv_cache_dtype="int8", weight_only_int8=True)
        run = drive_engine(eng, serve_prompts(cfg.vocab_size))
        layers = cfg.num_hidden_layers
        emit({"phase": "serve_int8_unfused", "flag": "FLAGS_use_fused_decode_layer=False",
              "config": "kv_cache_dtype=int8, weight_only_int8=True", **run["stats"], "launches": run["counts"],
              "card": card})
        check_served(run, eng, {"paged_chunk_int8": layers, "rms_norm_fwd": 2 * layers + 1,
                                "wo_matmul": 3 * layers + 1}, "serve_int8_unfused")
        profile_steps(eng, serve_prompts(cfg.vocab_size)[:8], card, label="profile_int8_unfused")
        del eng
        check_logits(model, dev, card, label="logits_int8_unfused", kv_int8=True)
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_use_fused_decode_layer": True})
    return run["counts"]


# -- training ------------------------------------------------------------------

TRAIN_KERNELS = (*FLASH_SOURCES, *NORM_ROPE_SOURCES, *FLXENT_SOURCES)
TRAIN_LAYERS = 8  # Llama-2-7B cut from 32 layers: 16 B/parameter of weights, grads, masters, moments
TRAIN_BATCH, TRAIN_SEQ = 2, 4096
TRAIN_CATEGORIES = (  # device kernel name substring -> category
    ("flash_fwd_kernel", "flash fwd (kernel 14)"), ("flash_bwd_dq_kernel", "flash dq (kernel 15)"),
    ("flash_bwd_dkv_kernel", "flash dk/dv (kernel 16)"), ("rms_fwd_kernel", "rmsnorm fwd (kernel 7)"),
    ("rms_bwd", "rmsnorm bwd (kernel 8)"), ("rope_fwd_kernel", "rope fwd (kernel 9)"),
    ("rope_bwd_kernel", "rope adjoint (kernel 10)"), ("column_sum", "norm backward column sums (kernels 8, 11, 13)"),
    ("ln_residual_bwd", "LN-residual bwd (kernel 13)"), ("ln_residual_kernel", "LN-residual fwd (kernel 12)"),
    ("flxent_logits", "fused loss logits (kernel 17)"), ("flxent_fwd", "fused loss logits (kernel 17)"),
    ("flxent_merge", "fused loss logits (kernel 17)"),
    ("flxent_wgmma", "fused loss D / dX / dW (kernels 18/19, wgmma)"),
    ("flxent_gemm", "fused loss dX / dW (kernels 18/19, mma.sync)"),
    ("flxent_tf32", "fused loss fp32 D / dX / dW (kernels 18/19, 3xTF32 wgmma)"),
    ("flxent_split", "fused loss fp32 operand split (3xTF32 planes)"),
    ("flxent_widen", "fused loss int8 W widened (2xTF32 plane)"), ("flxent_f32", "fused loss fp32 (17-19)"),
    ("gemm", "matmul"), ("cutlass", "matmul"),
    ("xmma", "matmul"), ("nvjet", "matmul"), ("foreach", "optimizer"), ("multi_tensor", "optimizer"),
    ("Memcpy", "memcpy"), ("Memset", "memcpy"),
)


def train_batch(dev, vocab: int, b: int, s: int, seed: int):
    """Seeded document-packed batch: ids, next-token labels within each
    document (-100 at every document's last position), and the C=1 causal
    FlashMask bounds ``[b, 1, s, 1]`` (each column's document end)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s))
    ends = doc_bounds(rng, b, s)
    labels = np.full((b, s), -100, np.int64)
    for i in range(b):
        for pos in range(s - 1):
            if pos + 1 < ends[i, pos]:
                labels[i, pos] = ids[i, pos + 1]
    docs = int(sum(len(np.unique(e)) for e in ends))
    return (torch.from_numpy(ids).to(dev), torch.from_numpy(labels).to(dev),
            torch.from_numpy(ends[:, None, :, None].copy()).to(dev), docs)


def plain_train_loss(model, ids, labels, bounds, dtype):
    """The train step's loss written out with the plain versions of the
    attention, RMSNorm and rope kernels (differentiated by autograd; the
    norm and rope in the kernels' rounding order: :func:`plain_llama_hidden`)
    and of the fused loss head (its ``Function`` on the plain versions) on
    ``dtype`` copies of the weights; returns the loss and each weight's
    gradient. In bf16 it is the plain path the kernel path is held to; in
    fp32 the reference both are measured against."""
    from paddle_tpu_torch.kernels.fused_loss import linear_cross_entropy

    w = {n: p.detach().to(dtype).requires_grad_() for n, p in model.named_parameters()}
    h = plain_llama_hidden(model, w, ids, bounds)
    loss = linear_cross_entropy(h, w["lm_head.weight"], labels, use_kernels=False)
    loss.backward()
    return loss.detach(), {n: t.grad for n, t in w.items()}


def check_train_accuracy(dev, card: dict, cfg=None, seq: int = 1024) -> None:
    """A 2-layer, S=1024 copy of the train step (same widths, recompute on):
    the kernel path's loss and every parameter's gradient against an fp32
    run of the plain versions, next to the bf16 plain path's distance from
    that reference. Gate (the logits phase's relative gate): per parameter,
    the kernel path's rel L2 at most 1.25x the plain bf16 path's; the loss's
    error at most max(1.25x the plain path's, 1e-3 relative)."""
    import torch
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = cfg or LlamaConfig(num_hidden_layers=2, recompute=True)
    model = LlamaForCausalLM(cfg, device=dev, seed=1)
    ids, labels, bounds, _ = train_batch(dev, cfg.vocab_size, 2, seq, seed=1)
    loss, _ = model(ids, labels=labels, startend_row_indices=bounds)
    loss.backward()
    loss = loss.detach()
    got = {n: p.grad for n, p in model.named_parameters()}
    loss_plain, plain = plain_train_loss(model, ids, labels, bounds, torch.bfloat16)
    loss_ref, ref = plain_train_loss(model, ids, labels, bounds, torch.float32)
    ratios = {n: rel_l2(got[n], ref[n]) / max(rel_l2(plain[n], ref[n]), 1e-30) for n in ref}
    worst = max(ratios, key=ratios.get)
    err_k, err_p = abs(float(loss) - float(loss_ref)), abs(float(loss_plain) - float(loss_ref))
    ok = (all(r <= 1.25 for r in ratios.values()) and err_k <= max(1.25 * err_p, 1e-3 * abs(float(loss_ref)))
          and all(bool(torch.isfinite(g).all()) for g in got.values()))
    emit({"phase": "train_accuracy", "layers": cfg.num_hidden_layers, "seq": seq, "loss_kernel": float(loss),
          "loss_plain_bf16": float(loss_plain), "loss_fp32": float(loss_ref),
          "grad_rel_l2_kernel_vs_fp32": {n: rel_l2(got[n], ref[n]) for n in ref},
          "grad_rel_l2_plain_vs_fp32": {n: rel_l2(plain[n], ref[n]) for n in ref},
          "worst_ratio": [worst, ratios[worst]],
          "tolerance": "per parameter kernel rel L2 <= 1.25 x plain bf16's; loss err <= max(1.25 x plain's, 1e-3 rel)",
          "card": card})
    if not ok:
        fail(f"train-step gradients through the kernels are further from fp32 than the plain path's "
             f"(worst {worst}: {ratios[worst]}; loss errors {err_k} vs {err_p})")


FLASH_EVENTS = {"flash_fwd": "flash_fwd_kernel", "flash_bwd_dq": "flash_bwd_dq_kernel",
                "flash_bwd_dkv": "flash_bwd_dkv_kernel"}  # launch counter -> device kernel name substring
# the fp32 loss head on the 3xTF32 instance: launch counters -> device kernel name substrings
TF32_LOSS_EVENTS = {("flxent_fwd",): ("flxent_fwd_tf32_kernel", "flxent_merge_kernel"),
                    ("flxent_dchunk", "flxent_dx", "flxent_dw"): ("flxent_tf32_kernel",),
                    ("flxent_split",): ("flxent_split_kernel",)}


def profile_train_step(step, card: dict, label: str = "train_profile", flash_cold=None) -> dict:
    """Where one train step's time goes: ``torch.profiler`` over one step,
    device time by category and the device's idle share of its wall time.
    The step's flash kernel events, counted by name, must equal the launch
    counters of the same step (so the profile's flash ms a step are those
    launches' time). Each flash kernel's in-step ms per launch (its events'
    ms over its launches) stands beside ``flash_cold``, its cold-L2 ms per
    call from ``check_flash`` under the step's mask, and each norm kernel's
    likewise (:func:`norm_in_step`). Returns the device ms by category."""
    from paddle_tpu_torch.kernels.select import launch_counts, reset_launch_counts

    def counted_step():
        reset_launch_counts()
        step()

    prof, wall_us = traced(counted_step)
    launches = launch_counts()
    spans, by_cat, by_name = [], {}, {}
    flash_events = {n: 0 for n in FLASH_EVENTS}
    flash_us = {n: 0.0 for n in FLASH_EVENTS}
    for e in cuda_events(prof):
        start, dur = e.time_range.start, e.time_range.elapsed_us()
        spans.append((start, start + dur))
        cat = next((c for key, c in TRAIN_CATEGORIES if key in e.name), "elementwise / other")
        by_cat[cat] = by_cat.get(cat, 0.0) + dur
        by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + dur
        for n, key in FLASH_EVENTS.items():
            if key in e.name:
                flash_events[n] += 1
                flash_us[n] += dur
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    by_cat_ms = {k: v / 1e3 for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1])}
    flash_launches = {n: launches[n] for n in FLASH_EVENTS}
    in_step = {n: {"in_step_ms_per_launch": flash_us[n] / 1e3 / max(1, flash_launches[n]),
                   "cold_ms_per_call": (flash_cold or {}).get(n)} for n in FLASH_EVENTS}
    loss_tf32 = {}  # the 3xTF32 loss head's events and launches, where the step ran it (its split pass launched)
    for counters, keys in TF32_LOSS_EVENTS.items():
        n_launch = sum(launches[c] for c in counters)
        if launches["flxent_split"]:
            evs = [e.time_range.elapsed_us() for e in cuda_events(prof) if any(k in e.name for k in keys)]
            loss_tf32["/".join(counters)] = {"events": len(evs), "launches": n_launch,
                                             "in_step_ms_per_launch": sum(evs) / 1e3 / n_launch}
    emit({"phase": label, "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
          "device_idle_share": (1 - busy / wall_us) if spans else None,
          "device_ms_by_category": by_cat_ms, "flash_events": flash_events, "flash_launches": flash_launches,
          "flash_in_step_vs_cold": in_step, "norm_in_step_vs_cold": norm_in_step(by_cat_ms, launches, label),
          **({"loss_head_tf32x3": loss_tf32} if loss_tf32 else {}),
          "top_kernels_ms": {k: v / 1e3 for k, v in top}, "cuda_events": len(spans), "card": card})
    if flash_events != flash_launches:
        first = [e.name[:40] for e in sorted(cuda_events(prof), key=lambda e: e.time_range.start)[:12]]
        fail(f"{label}: the profile holds flash kernel events {flash_events}, the launch counters {flash_launches} "
             f"({len(spans)} device events, the first {first})")
    uneven = {k: r for k, r in loss_tf32.items() if r["events"] != r["launches"]}
    if uneven:
        fail(f"{label}: the profile's 3xTF32 loss-head events are not its launches: {uneven}")
    return by_cat_ms


def compare_loss_heads(step, dev, want: dict, tokens: int, n_mfu: int, card: dict) -> None:
    """The same train step with ``FLAGS_use_fused_loss`` off (the JAX
    package's other path: ``[B, S, V]`` logits, then ``cross_entropy``)
    and on again, back to back on the same model: 1 warm-up and 4 timed
    steps each, peak memory from a reset before the warm-up. The unfused
    steps launch no loss kernel."""
    import numpy as np
    import torch
    import paddle_tpu_torch
    from paddle_tpu_torch.kernels.select import launch_counts, reset_launch_counts

    out = {}
    for fused in (False, True):
        paddle_tpu_torch.set_flags({"FLAGS_use_fused_loss": fused})
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            step()
            ms = []
            for _ in range(4):
                reset_launch_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                step()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
                counts = {k: v for k, v in launch_counts().items() if v}
                expect = {k: v for k, v in want.items() if fused or not k.startswith("flxent")}
                if counts != expect:
                    fail(f"train step with use_fused_loss={fused} launched {counts}, expected {expect}")
        finally:
            paddle_tpu_torch.set_flags({"FLAGS_use_fused_loss": True})
        p50 = float(np.median(ms))
        out["fused" if fused else "unfused"] = {
            "step_ms": ms, "step_ms_p50": p50, "tokens_per_s": tokens / (p50 / 1e3),
            "mfu": 6 * n_mfu * tokens / (p50 / 1e3) / BF16_FLOP_PER_S,
            "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    emit({"phase": "train_loss_heads", "order": "unfused (use_fused_loss=False), then fused, after the main run",
          **out, "card": card})


# fp32 step 1 against the plain fp32 path, limits set from readings on the card (NVIDIA H100 80GB HBM3, 700 W):
# the kernel path's worst gradient 8.7e-6 rel L2 and its loss the same bits; the plain path in one TF32 pass
# 3.8e-3 (gradient) and 1.8e-6 (loss)
FP32_TRAIN_GRAD_GATE = 1e-4  # every gradient within this rel L2 of the plain fp32 path's
FP32_TRAIN_LOSS_GATE = 1e-6  # the loss within this relative error of the plain fp32 path's


def plain_fp32_reference(model, ids, labels, bounds) -> dict:
    """The fp32 train step's first-step reference: :func:`plain_train_loss`
    in fp32 with TF32 off (the loss and every gradient), and beside it the
    same plain path with its matmuls in one TF32 pass
    (``torch.backends.cuda.matmul.allow_tf32``), the precision the 3xTF32
    kernels exist to beat, read against the reference."""
    import torch

    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        loss, grads = plain_train_loss(model, ids, labels, bounds, torch.float32)
        torch.backends.cuda.matmul.allow_tf32 = True
        loss_tf32, grads_tf32 = plain_train_loss(model, ids, labels, bounds, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    loss = float(loss)
    tf32 = {n: rel_l2(grads_tf32[n], grads[n]) for n in grads}
    del grads_tf32
    worst = max(tf32, key=tf32.get)
    return {"loss": loss, "grads": grads,
            "one_tf32_pass": {"loss_rel_err": abs(float(loss_tf32) - loss) / abs(loss),
                              "grad_rel_l2_worst": [worst, tf32[worst]]}}


def train(dev, card: dict, cfg=None, seq: int = TRAIN_SEQ, accuracy_cfg=None, accuracy_seq: int = 1024,
          steps: int = 5, full: bool = True, label: str = "train", flash_cold=None, plain_first: bool = False,
          profile: bool = False) -> dict:
    """Phase 6: Llama-2-7B widths at 8 layers, bf16 parameters, recompute on,
    ``AdamW(lr=1e-4, multi_precision=True)``, on one seeded document-packed
    batch of 2 x 4096 tokens (1 warm-up step, 4 timed). Gates: every
    parameter has a finite non-zero gradient on step 1; each step launches
    flash_fwd 16x (twice per layer: forward and recompute), flash_bwd_dq and
    flash_bwd_dkv 8x, rms_norm_fwd 33x (two norms per layer, twice, and the
    final norm), rms_norm_bwd 17x, rope_fwd 32x (q and k per layer, twice)
    and rope_bwd 16x, flxent_fwd 2x (partials and merge) and flxent_dchunk,
    flxent_dx and flxent_dw once per 4096-column vocab chunk (8x), and
    nothing else; the last loss is below the first;
    then the 2-layer accuracy copy. Returns the launch counts of the 5 steps.
    With ``full`` False it runs ``steps`` steps under the same gates (the
    loss's fall only over more than one step) and nothing after them but,
    with ``profile``, :func:`profile_train_step`. With ``plain_first`` (an
    fp32 model) the first step's loss and every gradient are held to
    :func:`plain_fp32_reference` on the same weights, within
    ``FP32_TRAIN_LOSS_GATE`` relative and ``FP32_TRAIN_GRAD_GATE`` rel L2;
    the plain path in one TF32 pass must miss the gradient gate."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels.select import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg = cfg or LlamaConfig(num_hidden_layers=TRAIN_LAYERS, recompute=True)
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(), multi_precision=True)
    ids, labels, bounds, docs = train_batch(dev, cfg.vocab_size, TRAIN_BATCH, seq, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    # MFU counts the matmul parameters only: the embedding table is a gather (PaLM's convention)
    n_mfu = n_params - model.llama.embed_tokens.weight.numel()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    first_ref = plain_fp32_reference(model, ids, labels, bounds) if plain_first else None
    grad_err = {}  # the first step's gradients against first_ref's, rel L2

    def step(check_grads: bool = False) -> float:
        loss, _ = model(ids, labels=labels, startend_row_indices=bounds)
        loss.backward()
        if check_grads:  # _assert_grad_coverage's gate
            bad = [n for n, p in model.named_parameters()
                   if p.grad is None or not bool(torch.isfinite(p.grad).all()) or not bool(p.grad.any())]
            if bad:
                fail(f"parameters without a finite non-zero gradient: {bad}")
            if first_ref is not None:
                ref = first_ref.pop("grads")
                grad_err.update({n: rel_l2(p.grad, ref[n]) for n, p in model.named_parameters()})
                del ref
        opt.step()
        opt.clear_grad()
        return float(loss.detach())

    layers = cfg.num_hidden_layers
    want = {fwd_counter(cfg.hidden_size // cfg.num_attention_heads, str(cfg.dtype)): 2 * layers,
            **{bwd_counter(k, cfg.hidden_size // cfg.num_attention_heads, str(cfg.dtype)): layers
               for k in ("flash_bwd_dq", "flash_bwd_dkv")},
            "rms_norm_fwd": 4 * layers + 1, "rms_norm_bwd": 2 * layers + 1,
            # the loss head: its forward's and backward's launches on the route its shapes take
            **loss_head_launches(TRAIN_BATCH * seq, cfg.hidden_size, cfg.vocab_size, getattr(torch, cfg.dtype),
                                 False)}
    if (cfg.hidden_size // cfg.num_attention_heads) % 128 == 0:  # kernels 9, 10: the JAX package's D % 128 gate
        want.update(rope_fwd=4 * layers, rope_bwd=2 * layers)
    losses, step_ms, counts, total, first_ms = [], [], None, {}, None
    for i in range(steps):
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(step(check_grads=i == 0))  # float(loss) syncs
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) * 1e3
        counts = launch_counts()
        if {k: v for k, v in counts.items() if v} != want:
            fail(f"train step {i + 1} launched {counts}, expected {want} and nothing else")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        if i:
            step_ms.append(dt)
        else:
            first_ms = dt
    tokens = TRAIN_BATCH * seq
    step_s = sum(step_ms or [dt]) / len(step_ms or [dt]) / 1e3
    # the matmuls' peak: the tensor cores' in bf16 / fp16; in fp32 (TF32 off) the CUDA cores'
    peak = FP32_FLOP_PER_S if cfg.dtype == "float32" else BF16_FLOP_PER_S
    if first_ref is not None:
        worst = max(grad_err, key=grad_err.get)
        vs_plain = {"loss_plain_fp32": first_ref["loss"], "loss_rel_err": abs(losses[0] - first_ref["loss"])
                    / abs(first_ref["loss"]), "grad_rel_l2_worst": [worst, grad_err[worst]],
                    "grad_rel_l2": grad_err, "one_tf32_pass": first_ref["one_tf32_pass"],
                    "limits": {"loss_rel_err": FP32_TRAIN_LOSS_GATE, "grad_rel_l2": FP32_TRAIN_GRAD_GATE}}
    emit({
        "phase": label, "model": f"llama2_7b widths, {layers} of 32 layers, {cfg.num_attention_heads} heads of "
                                 f"{cfg.hidden_size // cfg.num_attention_heads} (seeded random {cfg.dtype} weights)",
        "params": n_params, "batch": [TRAIN_BATCH, seq], "documents": docs,
        "recompute": True, "optimizer": "AdamW(lr=1e-4, multi_precision=True)", "setup_s": setup_s,
        "losses": losses, "first_step_ms": first_ms, "step_ms": step_ms or [dt],
        "step_ms_p50": float(np.median(step_ms or [dt])),
        "tokens_per_s": tokens / step_s,
        "params_in_mfu": n_mfu, "mfu": 6 * n_mfu * tokens / step_s / peak,
        "mfu_note": f"6 N T / step time / {peak:g}; N leaves out the embedding table (a gather); attention flops "
                    f"left out",
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "launches_per_step": counts, "launches_5_steps": total, "card": card,
        **({} if first_ref is None else {"first_step_vs_plain_fp32": vs_plain}),
    })
    if not all(np.isfinite(losses)) or (steps > 1 and not losses[-1] < losses[0]):
        fail(f"the loss did not decrease over the steps: {losses}")
    if first_ref is not None:
        if vs_plain["loss_rel_err"] > FP32_TRAIN_LOSS_GATE or grad_err[worst] > FP32_TRAIN_GRAD_GATE:
            fail(f"{label}: step 1 is further from the plain fp32 path than the limits {vs_plain['limits']}: "
                 f"loss {vs_plain['loss_rel_err']}, {worst}'s gradient {grad_err[worst]}")
        if first_ref["one_tf32_pass"]["grad_rel_l2_worst"][1] <= FP32_TRAIN_GRAD_GATE:
            fail(f"{label}: the plain path in one TF32 pass meets the gradient limit {FP32_TRAIN_GRAD_GATE} "
                 f"({first_ref['one_tf32_pass']}): the limit cannot tell it from three")
    if not full:
        if profile:
            profile_train_step(step, card, label=f"{label}_profile", flash_cold=flash_cold)
        return total
    profile_train_step(step, card, flash_cold=flash_cold)
    compare_loss_heads(step, dev, want, tokens, n_mfu, card)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    check_train_accuracy(dev, card, accuracy_cfg, accuracy_seq)
    return total


# -- fp16: the flash kernels' dtype repair, end to end -------------------------

FP16_LAYERS = 2
FP16_GEN = (2, 512, 8)  # prompts, prompt tokens, new tokens


def plain_llama_hidden(model, w: dict, ids, bounds):
    """The Llama forward up to the final norm written out with the plain
    versions of the attention, RMSNorm and rope kernels (in the kernels'
    rounding order) on the weights ``w`` (name -> tensor, of the dtype the
    run computes in)."""
    from paddle_tpu_torch.kernels.flash_attention import flash_fwd_plain
    from paddle_tpu_torch.kernels.fused import rms_norm_fwd_plain, rope_fwd_plain
    from paddle_tpu_torch.nn.functional import swiglu

    def rms_norm(x, weight, epsilon):
        return rms_norm_fwd_plain(x, weight, epsilon)[0]

    cfg = model.config
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    hd = cfg.hidden_size // nh
    b, s = ids.shape
    eps = cfg.rms_norm_eps
    cos, sin = model.llama.rotary_emb(s)
    h = w["llama.embed_tokens.weight"][ids]
    for i in range(cfg.num_hidden_layers):
        pre = f"llama.layers.{i}."
        x = rms_norm(h, w[pre + "input_layernorm.weight"], eps)
        q = (x @ w[pre + "self_attn.q_proj.weight"]).reshape(b, s, nh, hd)
        k = (x @ w[pre + "self_attn.k_proj.weight"]).reshape(b, s, nkv, hd)
        v = (x @ w[pre + "self_attn.v_proj.weight"]).reshape(b, s, nkv, hd)
        q, k = rope_fwd_plain(q, cos, sin), rope_fwd_plain(k, cos, sin)
        a, _ = flash_fwd_plain(q, k, v, bounds, True)
        h = h + a.reshape(b, s, nh * hd) @ w[pre + "self_attn.o_proj.weight"]
        x = rms_norm(h, w[pre + "post_attention_layernorm.weight"], eps)
        h = h + swiglu(x @ w[pre + "mlp.gate_proj.weight"], x @ w[pre + "mlp.up_proj.weight"]) @ w[pre + "mlp.down_proj.weight"]
    return rms_norm(h, w["llama.norm.weight"], eps)


def fp16_phase(dev, card: dict) -> dict:
    """The flash kernels' fp16 repair end to end: a 2-layer Llama-2-7B-width
    model with ``dtype="float16"`` and recompute on trains one step through
    :func:`train` (2 x 4096 document-packed tokens: every parameter a finite
    non-zero gradient, flash 4/2/2 launches and the rest of the train
    step's, the loss reported), then a fresh fp16 model runs
    ``generate_paged`` on 2 x 512 prompts with 8 new tokens: output
    ``[2, 520]`` int32 after the prompts, launches gated (the dense prefill:
    flash_fwd 2, rope_fwd 4, rms_norm_fwd 5; each of the 7 decode steps
    paged_decode 2, rms_norm_fwd 5), and the prefill's logits through the
    relative gate of :func:`logits_gate` against the fp16 plain path's own
    distance from an fp32 run of the plain versions. Returns the launches
    of both."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels.select import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(num_hidden_layers=FP16_LAYERS, recompute=True, dtype="float16")
    counts = train(dev, card, cfg=cfg, steps=1, full=False, label="train_fp16")
    gc.collect()
    torch.cuda.empty_cache()
    model = LlamaForCausalLM(cfg, device=dev, seed=2)
    model.eval()
    b, prompt, new = FP16_GEN
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, prompt)).astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    out = model.generate_paged(ids, max_new_tokens=new, block_size=16)
    torch.cuda.synchronize()
    gen_counts = {k: v for k, v in launch_counts().items() if v}
    layers = cfg.num_hidden_layers
    want = {"flash_fwd": layers, "rope_fwd": 2 * layers, "paged_decode": (new - 1) * layers,
            "rms_norm_fwd": new * (2 * layers + 1)}
    if tuple(out.shape) != (b, prompt + new) or out.dtype != torch.int32 or not torch.equal(out[:, :prompt], ids):
        fail(f"fp16 generate_paged returned {tuple(out.shape)} {out.dtype}, want [{b}, {prompt + new}] int32 "
             "after the prompts")
    if gen_counts != want:
        fail(f"fp16 generate_paged launched {gen_counts}, want {want} and nothing else")
    with torch.inference_mode():
        reset_launch_counts()
        got, _ = model(ids.long(), use_cache=True)  # the dense prefill: kernel 14 in fp16
        prefill = {k: v for k, v in launch_counts().items() if v}
        if prefill.get("flash_fwd") != layers:
            fail(f"the fp16 dense prefill launched {prefill}, want flash_fwd {layers}")
        got = got.float().reshape(-1, cfg.vocab_size)
        params = dict(model.named_parameters())
        lm = "lm_head.weight"
        plain = (plain_llama_hidden(model, params, ids.long(), None) @ params[lm]).float()
        f32 = {n: p.float() for n, p in params.items()}
        ref = plain_llama_hidden(model, f32, ids.long(), None) @ f32[lm]
    emit({"phase": "generate_paged_fp16", "layers": layers, "batch": b, "prompt_tokens": prompt, "new_tokens": new,
          "launches": gen_counts, "prefill_launches": prefill, "card": card})
    logits_gate(got, plain.reshape(-1, cfg.vocab_size), ref.reshape(-1, cfg.vocab_size), "logits_prefill_fp16", card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"train": counts, "generate": gen_counts}


FP32_TRAIN_LAYERS, FP32_TRAIN_STEPS = 2, 3


def train_fp32(dev, card: dict, flash_cold=None) -> dict:
    """Kernels 15 and 16 in fp32 on a main path: a 2-layer Llama-2-7B-width
    model with ``dtype="float32"`` and recompute on trains 3 steps through
    :func:`train` (the seeded document-packed 2 x 4096 batch,
    ``AdamW(multi_precision=True)``: every parameter a finite non-zero
    gradient, each step's launches, flash 4 / 2 / 2 on the fp32 kernels
    (``csrc/flash_fwd_tf32.cu``, ``csrc/flash_bwd_tf32.cu``) beside the
    RMSNorm, rope and fp32 loss-head kernels (17, D / 18 / 19 and their
    split pass on ``csrc/flxent_tf32.cu``), and nothing else, a
    falling loss), its first step's loss and gradients held to the plain
    versions' fp32 path on the same weights (:func:`plain_fp32_reference`),
    and a profile of one more step (each flash kernel's in-step ms per
    launch beside ``flash_cold``, its cold-L2 ms per call at the step's
    shape and mask from ``check_flash``; the 3xTF32 loss-head kernels'
    in-step ms per launch). Returns the launches of the 3 steps."""
    import torch
    from paddle_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig(num_hidden_layers=FP32_TRAIN_LAYERS, recompute=True, dtype="float32")
    counts = train(dev, card, cfg=cfg, steps=FP32_TRAIN_STEPS, full=False, label="train_fp32", plain_first=True,
                   profile=True, flash_cold=flash_cold)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


WO_SERVE_LAYERS = 2  # the fp16 / fp32 weight-only serve phases: Llama-2-7B widths cut to 2 of 32 layers


def serve_weight_only(dev, card: dict, dtype: str) -> dict:
    """Kernel 20 on the serving path in fp16 and fp32: a 2-layer
    Llama-2-7B-width model of ``dtype`` (seeded random weights) served
    through ``ContinuousBatchingEngine`` with ``weight_only_int8=True`` (its
    pools in the model's dtype) on 4 of the serve phase's requests, the
    launch counters reset just before and read just after: every request
    finishes with 32 tokens, each step launches kernel A 2x, B 1x, C 4x and
    kernel 20 7x (three projections a layer and the head: fp16 on the wgmma
    instance, fp32 on the mma.sync one) and nothing else, the pool drains;
    then one mixed step's logits through :func:`check_logits` (the int8
    plain path in ``dtype`` and a higher-precision run of it); then
    :func:`eval_loss` on the quantized model: kernel 17's int8 site (fp16
    twice on kernel 20's wgmma mainloop; fp32 on its 2xTF32 instance, a
    widen and a partials launch per sub-chunk, then the merge), its loss
    within 1e-4 of max(1, |loss|) of the plain int8 head's. Returns the
    launch counts of the engine run (``"serve"``) and of the evaluation
    loss (``"eval"``)."""
    import torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.kernels.quant import wo_route
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    label = f"serve_weight_only_{dtype}"
    cfg = LlamaConfig(num_hidden_layers=WO_SERVE_LAYERS, dtype=dtype)
    model = LlamaForCausalLM(cfg, device=dev, seed=4)
    eng = ContinuousBatchingEngine(model, **SERVE_ENGINE, weight_only_int8=True)
    run = drive_engine(eng, serve_prompts(cfg.vocab_size)[:4])
    layers = cfg.num_hidden_layers
    h, inter, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    routes = {name: wo_route(model.dtype, 512, k, n) for name, (k, n) in
              {"gate_up": (h, inter), "down": (inter, h), "lm_head": (h, v)}.items()}
    emit({"phase": label, "model": f"llama2_7b widths, {layers} of 32 layers (seeded random {dtype} weights)",
          "config": "weight_only_int8=True", **run["stats"], "quantized_params": len(eng._wq_params),
          "wo_matmul_routes": routes, "launches": run["counts"], "pool": eng.pool_stats(), "card": card})
    if len(eng._wq_params) != 3 * layers + 1:
        fail(f"{label}: {len(eng._wq_params)} projections quantized, want {3 * layers + 1}")
    check_served(run, eng, {"paged_chunk_fused": layers, "embed_rms": 1, "rms_residual": 2 * layers,
                            "wo_matmul": 3 * layers + 1}, label)
    del eng
    check_logits(model, dev, card, label=f"logits_weight_only_{dtype}")
    _, eval_counts = eval_loss(model, dev, card, f"eval_loss_weight_only_{dtype}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"serve": run["counts"], "eval": eval_counts}


# -- GPT-3 13B widths: pretraining through kernels 12, 13, 14-16, 17-19 ----------

GPT_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "ln_residual", "ln_residual_bwd",
               "flxent_fwd", "flxent_dchunk", "flxent_dx", "flxent_dw")
GPT_LAYERS = 8  # GPT-3 13B cut from 40 layers: 16 B/parameter of weights, grads, masters, moments
GPT_BATCH, GPT_SEQ = 4, 2048


def gpt_batch(dev, vocab: int, b: int, s: int, seed: int):
    """Seeded ids and their next-token labels (-100 at each row's end)."""
    import numpy as np
    import torch

    ids = np.random.default_rng(seed).integers(0, vocab, (b, s))
    labels = np.full((b, s), -100, np.int64)
    labels[:, :-1] = ids[:, 1:]
    return torch.from_numpy(ids).to(dev), torch.from_numpy(labels).to(dev)


def plain_gpt_loss(model, ids, labels, dtype):
    """The GPT train step's loss written out with the plain versions of the
    flash-attention forward, the residual LayerNorm (kernel 12) and the
    fused loss head (vocab-major, its ``Function`` on the plain versions),
    differentiated by autograd, and the JAX composition for ``ln_1`` and
    ``ln_f``, on ``dtype`` copies of the weights; returns the loss and each
    weight's gradient (as ``plain_train_loss`` does for Llama)."""
    import torch
    from paddle_tpu_torch.kernels.flash_attention import flash_fwd_plain
    from paddle_tpu_torch.kernels.fused import ln_residual_plain
    from paddle_tpu_torch.kernels.fused_loss import linear_cross_entropy
    from paddle_tpu_torch.nn.functional import gelu, layer_norm

    w = {n: p.detach().to(dtype).requires_grad_() for n, p in model.named_parameters()}
    cfg = model.config
    nh, hd, eps = cfg.num_heads, cfg.hidden_size // cfg.num_heads, cfg.layer_norm_epsilon
    b, s = ids.shape
    h = w["gpt.embeddings.word_embeddings.weight"][ids] + w["gpt.embeddings.position_embeddings.weight"][:s][None]
    for i in range(cfg.num_layers):
        pre = f"gpt.layers.{i}."

        def lin(t, name):
            return t @ w[pre + name + ".weight"] + w[pre + name + ".bias"]

        x = layer_norm(h, None, w[pre + "ln_1.weight"], w[pre + "ln_1.bias"], eps)
        qkv = lin(x, "attn.qkv_proj").reshape(b, s, 3, nh, hd)
        a, _ = flash_fwd_plain(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], None, True)
        attn = lin(a.reshape(b, s, nh * hd), "attn.out_proj")
        h2, x2 = ln_residual_plain(attn, w[pre + "ln_2.weight"], w[pre + "ln_2.bias"], h, eps)
        h = x2 + lin(gelu(lin(h2, "mlp.fc1")), "mlp.fc2")
    h = layer_norm(h, None, w["gpt.ln_f.weight"], w["gpt.ln_f.bias"], eps)
    loss = linear_cross_entropy(h, w["gpt.embeddings.word_embeddings.weight"], labels, vocab_major=True,
                                use_kernels=False)
    loss.backward()
    return loss.detach(), {n: t.grad for n, t in w.items()}


def check_gpt_accuracy(dev, card: dict, cfg=None, seq: int = 1024) -> None:
    """A 2-layer, full-width, S=1024 copy of the GPT train step: the kernel
    path's loss and every parameter's gradient against an fp32 run of the
    plain versions, beside the bf16 plain path's distance from it; the gate
    of ``check_train_accuracy`` (per parameter rel L2 at most 1.25x the
    plain bf16 path's; the loss error at most max(1.25x the plain path's,
    1e-3 relative))."""
    import torch
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining

    cfg = cfg or GPTConfig(num_layers=2)
    model = GPTForPretraining(cfg, device=dev, dtype=torch.bfloat16, seed=1)
    ids, labels = gpt_batch(dev, cfg.vocab_size, 2, seq, seed=1)
    loss, _ = model(ids, labels=labels)
    loss.backward()
    loss = loss.detach()
    got = {n: p.grad for n, p in model.named_parameters()}
    loss_plain, plain = plain_gpt_loss(model, ids, labels, torch.bfloat16)
    loss_ref, ref = plain_gpt_loss(model, ids, labels, torch.float32)
    ratios = {n: rel_l2(got[n], ref[n]) / max(rel_l2(plain[n], ref[n]), 1e-30) for n in ref}
    worst = max(ratios, key=ratios.get)
    err_k, err_p = abs(float(loss) - float(loss_ref)), abs(float(loss_plain) - float(loss_ref))
    ok = (all(r <= 1.25 for r in ratios.values()) and err_k <= max(1.25 * err_p, 1e-3 * abs(float(loss_ref)))
          and all(bool(torch.isfinite(g).all()) for g in got.values()))
    emit({"phase": "train_gpt_accuracy", "layers": cfg.num_layers, "seq": seq, "loss_kernel": float(loss),
          "loss_plain_bf16": float(loss_plain), "loss_fp32": float(loss_ref),
          "grad_rel_l2_kernel_vs_fp32": {n: rel_l2(got[n], ref[n]) for n in ref},
          "grad_rel_l2_plain_vs_fp32": {n: rel_l2(plain[n], ref[n]) for n in ref},
          "worst_ratio": [worst, ratios[worst]],
          "tolerance": "per parameter kernel rel L2 <= 1.25 x plain bf16's; loss err <= max(1.25 x plain's, 1e-3 rel)",
          "card": card})
    if not ok:
        fail(f"GPT train-step gradients through the kernels are further from fp32 than the plain path's "
             f"(worst {worst}: {ratios[worst]}; loss errors {err_k} vs {err_p})")


def train_gpt(dev, card: dict, cfg=None, batch: int = GPT_BATCH, seq: int = GPT_SEQ, accuracy_cfg=None,
              accuracy_seq: int = 1024, flash_cold=None) -> dict:
    """Phase 7: GPT-3 13B widths (hidden 5120, 40 heads of dim 128, vocab
    50304, FFN 4x, biases, tied lm head) cut to 8 layers, bf16 parameters
    (seeded N(0, 0.02), LayerNorm weights 1, biases 0), every JAX default
    (``FLAGS_use_fused_decode_layer`` and ``FLAGS_use_fused_loss`` on,
    dropout 0), ``AdamW(lr=1e-4, multi_precision=True)``, on one seeded
    batch of 4 x 2048 tokens with the next token as label (1 warm-up step,
    4 timed). Gates: every parameter has a finite non-zero gradient on step
    1; each step launches flash_fwd, flash_bwd_dq, flash_bwd_dkv,
    ln_residual and ln_residual_bwd once per layer, flxent_fwd 2x and
    flxent_dchunk / dx / dw once per 4096-column vocab chunk (13x), and
    nothing else; the last loss is below the first; then the 2-layer
    accuracy copy. Returns the launch counts of the 5 steps."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels.fused_loss import CHUNK
    from paddle_tpu_torch.kernels.select import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg = cfg or GPTConfig(num_layers=GPT_LAYERS)
    model = GPTForPretraining(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(), multi_precision=True)
    ids, labels = gpt_batch(dev, cfg.vocab_size, batch, seq, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    # MFU counts the 8 layers and the tied head's product: not the position
    # table (a gather), not the attention's score products
    n_mfu = n_params - model.gpt.embeddings.position_embeddings.weight.numel()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def step(check_grads: bool = False) -> float:
        loss, _ = model(ids, labels=labels)
        loss.backward()
        if check_grads:  # _assert_grad_coverage's gate
            bad = [n for n, p in model.named_parameters()
                   if p.grad is None or not bool(torch.isfinite(p.grad).all()) or not bool(p.grad.any())]
            if bad:
                fail(f"GPT parameters without a finite non-zero gradient: {bad}")
        opt.step()
        opt.clear_grad()
        return float(loss.detach())

    layers = cfg.num_layers
    chunks = -(-cfg.vocab_size // CHUNK)
    want = {"flash_fwd": layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers,
            "ln_residual": layers, "ln_residual_bwd": layers,
            "flxent_fwd": 2, "flxent_dchunk": chunks, "flxent_dx": chunks, "flxent_dw": chunks}
    losses, step_ms, counts, total = [], [], None, {}
    for i in range(5):
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(step(check_grads=i == 0))
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) * 1e3
        counts = launch_counts()
        if {k: v for k, v in counts.items() if v} != want:
            fail(f"GPT train step {i + 1} launched {counts}, expected {want} and nothing else")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        if i:
            step_ms.append(dt)
    tokens = batch * seq
    p50 = float(np.median(step_ms))
    emit({
        "phase": "train_gpt", "model": f"GPT-3 13B widths, {layers} of 40 layers (seeded random bf16 weights)",
        "params": n_params, "batch": [batch, seq], "optimizer": "AdamW(lr=1e-4, multi_precision=True)",
        "flags": {"use_fused_decode_layer": True, "use_fused_loss": True}, "setup_s": setup_s,
        "losses": losses, "step_ms": step_ms, "step_ms_p50": p50, "tokens_per_s": tokens / (p50 / 1e3),
        "params_in_mfu": n_mfu, "mfu": 6 * n_mfu * tokens / (p50 / 1e3) / BF16_FLOP_PER_S,
        "mfu_note": "6 N T / step p50 / 989e12; N: the layers and the tied head, not the position table; "
                    "attention flops left out",
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "launches_per_step": counts, "launches_5_steps": total, "card": card,
    })
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"the GPT loss did not decrease over the steps: {losses}")
    profile_train_step(step, card, "train_gpt_profile", flash_cold)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    check_gpt_accuracy(dev, card, accuracy_cfg, accuracy_seq)
    return total


# -- head dims above 256 end to end (ROADMAP Queue 3 fault 2, closed) ----------------------

# (label, hidden, intermediate, engine runs only) at 8 heads, GQA 8/2: Llama-2-7B's widths with heads of
# 512, the same at heads of 320 (hidden 2560), and heads of 576 (hidden 4608) through the engine only. No
# model the JAX package configures reaches a head dim above 256 by default; these make the port's wide
# instances (14-16, A, 4, 5, 6 at D 512 and 320; A and 4's deep instance at 576) the path's.
WIDE_HEADS = (("d512", 4096, 11008, False), ("d320", 2560, 6912, False), ("d576", 4608, 11008, True))
WIDE_LAYERS = 2  # cut from 32 layers: the path, not the model's depth, is what the phase drives
WIDE_GEN = (2, 512, 8)  # prompts, prompt tokens, new tokens


def wide_heads(dev, card: dict) -> dict:
    """The repair of head dims above 256, end to end on the port's main
    paths: for each of :data:`WIDE_HEADS` (2 layers, 8 heads, GQA 8/2,
    vocab 32000, seeded random bf16 weights),

    - 4 of the serve phase's requests through ``ContinuousBatchingEngine``
      fused (each step kernel A 2x, B 1x, C 4x) and unfused (kernel 4 2x,
      7 5x), each again over the int8 KV pool (``kv_cache_dtype="int8"``:
      A's / 4's int8 instances): every request finishes with 32 tokens,
      those launches a step and nothing else, the pool drains, and one
      mixed step's logits pass :func:`check_logits`' gate (at most 1.25x
      the bf16 plain path's distance from fp32) (d576: these runs alone,
      A's and 4's deep instance);
    - ``generate_paged`` on 2 x 512 prompts, 8 new tokens: the prefill
      flash_fwd 2x, rms_norm_fwd 5x (and rope_fwd 4x at D 512: the rope
      kernel takes D % 128, the JAX package's gate), each decode step
      kernel 5 2x and rms_norm_fwd 5x, and the prefill's logits through
      the same gate;
    - two train steps (recompute on) on 2 x 4096 document-packed tokens
      under the FlashMask document mask through :func:`train` (the
      second's time is the step's reading, the first's is printed beside
      it), each launching kernels 14-16 4/2/2 on their wide instances (``flash_fwd_wide``,
      ``flash_bwd_dq_wide``, ``flash_bwd_dkv_wide``) and the rest of the
      step's launches (rope 8/4 at D 512 only), every parameter a finite
      non-zero gradient.

    Returns the launch counts of each run."""
    import numpy as np
    import torch
    import paddle_tpu_torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.kernels.select import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    out = {}
    layers = WIDE_LAYERS
    for label, hidden, inter, engine_only in WIDE_HEADS:
        kw = dict(hidden_size=hidden, intermediate_size=inter, num_attention_heads=8, num_key_value_heads=2,
                  num_hidden_layers=layers)
        cfg = LlamaConfig(**kw)
        model = LlamaForCausalLM(cfg, device=dev, seed=9)
        desc = (f"llama2_7b widths with 8 heads of {hidden // 8} (hidden {hidden}, intermediate {inter}, GQA 8/2), "
                f"{layers} layers (seeded random bf16 weights)")
        for kv in ("bf16", "int8"):
            for fused in (True, False):
                name = f"wide_heads_{label}_{'fused' if fused else 'unfused'}_{kv}"
                paddle_tpu_torch.set_flags({"FLAGS_use_fused_decode_layer": fused})
                try:
                    eng = ContinuousBatchingEngine(model, **SERVE_ENGINE, **({"kv_cache_dtype": "int8"} if kv == "int8" else {}))
                    run = drive_engine(eng, serve_prompts(cfg.vocab_size)[:4])
                    sfx = "_int8" * (kv == "int8")
                    want = ({"paged_chunk_fused" + sfx: layers, "embed_rms": 1, "rms_residual": 2 * layers} if fused
                            else {"paged_chunk" + sfx: layers, "rms_norm_fwd": 2 * layers + 1})
                    emit({"phase": name, "model": desc, "kv_cache_dtype": kv, **run["stats"],
                          "launches": run["counts"], "card": card})
                    check_served(run, eng, want, name)
                    del eng
                    check_logits(model, dev, card, label=f"logits_{name}", kv_int8=kv == "int8")
                finally:
                    paddle_tpu_torch.set_flags({"FLAGS_use_fused_decode_layer": True})
                out[name] = run["counts"]
        if engine_only:
            del model
            gc.collect()
            torch.cuda.empty_cache()
            continue
        b, prompt, new = WIDE_GEN
        ids = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (b, prompt)).astype(np.int32)).to(dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        gen_out = model.generate_paged(ids, max_new_tokens=new, block_size=16)
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        want = {fwd_counter(hidden // 8, str(cfg.dtype)): layers, "paged_decode": (new - 1) * layers,
                "rms_norm_fwd": new * (2 * layers + 1)}
        if (hidden // 8) % 128 == 0:  # the rope kernel takes D % 128 (the JAX package's gate); D 320 composes
            want["rope_fwd"] = 2 * layers
        emit({"phase": f"wide_heads_{label}_generate_paged", "model": desc, "batch": b, "prompt_tokens": prompt,
              "new_tokens": new, "launches": counts, "card": card})
        if tuple(gen_out.shape) != (b, prompt + new) or not torch.equal(gen_out[:, :prompt], ids):
            fail(f"wide_heads {label}: generate_paged returned {tuple(gen_out.shape)}, want [{b}, {prompt + new}] "
                 "after the prompts")
        if counts != want:
            fail(f"wide_heads {label}: generate_paged launched {counts}, want {want} and nothing else")
        out[f"wide_heads_{label}_generate_paged"] = counts
        with torch.inference_mode():
            got, _ = model(ids.long(), use_cache=True)  # the dense prefill: kernel 14 at the wide head dim
            got = got.float().reshape(-1, cfg.vocab_size)
            params = dict(model.named_parameters())
            plain = (plain_llama_hidden(model, params, ids.long(), None) @ params["lm_head.weight"]).float()
            f32 = {n: p.float() for n, p in params.items()}
            ref = plain_llama_hidden(model, f32, ids.long(), None) @ f32["lm_head.weight"]
        logits_gate(got, plain.reshape(-1, cfg.vocab_size), ref.reshape(-1, cfg.vocab_size),
                    f"logits_wide_heads_{label}_prefill", card)
        del model, got, plain, ref, params, f32
        gc.collect()
        torch.cuda.empty_cache()
        out[f"wide_heads_{label}_train"] = train(dev, card, cfg=LlamaConfig(**kw, recompute=True), steps=2,
                                                 full=False, label=f"wide_heads_{label}_train")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        print("chip_smoke: paddle_tpu_torch/ is not beside this script; run it from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels.select import KERNELS, LAYOUT_PASSES

    dev = torch.device("cuda", 0)
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    card = {"name": name, "nvidia_smi": smi}
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda, "kind": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi})

    info = build.build_info()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if ("ptxas info" in ln and ("Used" in ln or "Compiling" in ln)) or "spill stores" in ln]
    done_by = {m[0]: float(m[1]) for m in re.findall(r"== nvcc (\S+) \(rc \d+, done by ([\d.]+) s\)", info["log"])}
    emit({"phase": "build", "seconds": info["seconds"], "cached": info["cached"], "sources_done_by_seconds": done_by,
          "ptxas": ptxas})

    records, flash_cold = check_kernels(dev, card)
    KERNEL_RECORDS.update(records)
    model, counts, streams = serve(dev, card)  # the engine and its pool are released here
    check_logits(model, dev, card)
    counts["paged_chunk"] = serve_unfused(model, dev, card, streams)["paged_chunk"]
    counts["paged_decode"] = generate_paged_phase(model, dev, card)["paged_decode"]
    counts["paged_decode_fused"] = check_decode_entry(dev, torch.Generator(device=dev).manual_seed(5),
                                                      card)["paged_decode_fused"]
    bf16_loss, _ = eval_loss(model, dev, card, "eval_loss_bf16")  # before the int8 engine quantizes the model
    int8_counts = serve_int8(model, dev, card, streams)  # quantizes the MLP projections and the lm head in place
    counts.update({k: int8_counts[k] for k in ("paged_chunk_fused_int8", "wo_matmul")})
    counts["paged_chunk_int8"] = serve_int8_unfused(model, dev, card)["paged_chunk_int8"]
    int8_loss, eval_counts = eval_loss(model, dev, card, "eval_loss_int8")
    emit({"phase": "eval_loss_int8_vs_bf16", "loss_bf16": bf16_loss, "loss_int8": int8_loss,
          "difference": int8_loss - bf16_loss, "card": card})
    counts["flxent_fwd_int8"] = eval_counts["flxent_fwd_int8"]
    gen = torch.Generator(device=dev).manual_seed(8)
    for fused in (False, True):  # no model path reaches kernels 5 and 6 with an int8 pool: their public entries
        counts.update({k: c for k, c in check_decode_entry(dev, gen, card, fused=fused, int8=True).items() if c})
    del model  # the 7B serving model, before the train phase
    gc.collect()
    torch.cuda.empty_cache()
    counts.update({k: v for k, v in train(dev, card, flash_cold=flash_cold["llama, document mask [2, 4096, 32, 128]"]).items()
                   if k in TRAIN_KERNELS})
    gc.collect()
    torch.cuda.empty_cache()
    fp16_phase(dev, card)
    counts["flxent_split"] = train_fp32(dev, card, flash_cold["llama fp32, document mask [2, 4096, 32, 128]"])[
        "flxent_split"]
    serve_weight_only(dev, card, "float16")  # kernel 20 on the serving path in every dtype it takes
    # the fp32 model's evaluation loss widens its int8 head's sub-chunks
    counts["flxent_widen"] = serve_weight_only(dev, card, "float32")["eval"]["flxent_widen"]
    counts.update({k: v for k, v in train_gpt(dev, card, flash_cold=flash_cold["gpt, causal [4, 2048, 40, 128]"]).items()
                   if k in ("ln_residual", "ln_residual_bwd")})
    counts["rms_residual_bwd"] = check_residual_repair(dev, torch.Generator(device=dev).manual_seed(6),
                                                       card)["rms_residual_bwd"]
    gc.collect()
    torch.cuda.empty_cache()
    wide = wide_heads(dev, card)
    for k in ("flash_fwd_wide", "flash_bwd_dq_wide", "flash_bwd_dkv_wide"):
        counts[k] = sum(wide[f"wide_heads_{label}_train"].get(k, 0) for label, *_, engine_only in WIDE_HEADS
                        if not engine_only)
    emit({"phase": "norm_in_step_vs_cold", "kernels": IN_STEP_READINGS,
          "note": "in-step: the profile's device ms of the kernel's categories over its own launch counter in the "
                  "window (8 and 13 with their column sums); cold: device ms per call with the L2 flushed, at the "
                  "kernel phase's shapes", "card": card})
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": records[k]["source"], "replaces": KERNELS[k],
         "launches": counts[k], "max_abs_err": records[k]["max_abs_err"], "ms": records[k]["ms"],
         "plain_ms": records[k]["plain_ms"], "bound_ms": records[k]["bound_ms"],
         "bound_by": records[k]["bound_by"], "library_ms": records[k]["library_ms"],
         "sources": records[k].get("sources", {"all": records[k]["source"]}),
         **({"layout_pass": LAYOUT_PASSES[k]} if k in LAYOUT_PASSES else {})}
        for k in KERNELS
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
