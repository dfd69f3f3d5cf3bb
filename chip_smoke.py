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
   q_lens=0 rows), and time kernel, plain version and, where one PyTorch
   call computes the same function, that call (device time per call from
   ``torch.profiler`` with the L2 flushed before each call; back-to-back
   wall time per call, launch overhead included, as ``call_ms``);
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
   measured against the plain versions run in fp32.

Then the kernel table as one JSON line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. The script exits non-zero at the first
failed check, without a CUDA card, and outside a checkout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak (data sheet)
BF16_REL = 2.0 ** -7  # one bf16 ulp relative to the value (8-bit significand)


def emit(obj: dict) -> None:
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

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


L2_FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2
FLUSH_KERNEL = "FillFunctor<signed char>"  # the flush's fill kernel, left out of the sums


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one ``fn()`` call with a cold L2: before each call
    a 64 MB int8 buffer is filled, then ``torch.profiler`` sums the
    durations of the kernels and copies ``fn`` ran (the flush's own fill
    kernels excluded), over ``iters`` calls after a warm-up. Launch overhead
    between kernels is not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.int8, device="cuda")
    for i in range(warmup):
        flush.fill_(i + 1)
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            flush.fill_(i % 100 + 1)
            fn()
        torch.cuda.synchronize()
    events = cuda_events(prof)
    flushes = [e for e in events if FLUSH_KERNEL in e.name]
    if len(flushes) != iters:
        fail(f"expected {iters} L2-flush kernels named {FLUSH_KERNEL!r} in the profile, found {len(flushes)}")
    return sum(e.time_range.elapsed_us() for e in events if FLUSH_KERNEL not in e.name) / iters / 1e3


def bound(nbytes: float, flops: float) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def within(got, want, atol: float, rel: float):
    """(max abs error, ok): every element within ``atol + rel * max(|got|, |want|)``."""
    import torch

    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool((err <= atol + rel * torch.maximum(g.abs(), w.abs())).all())
    return float(err.max()), ok


# -- kernel A inputs -----------------------------------------------------------

def paged_batch(dev, gen, hq: int, hkv: int, d: int = 128, bs: int = 16, c: int = 64, mbs: int = 128):
    """A mixed batch of 8 slots: two full prompt chunks, decode rows, a
    partial chunk and an idle slot (q_lens 0) with stale lens. Table entries
    past each slot's used blocks hold out-of-range garbage."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaRotaryEmbedding

    q_lens = torch.tensor([64, 64, 1, 1, 1, 40, 0, 1], dtype=torch.int32)
    lens = torch.tensor([0, 192, 511, 300, 63, 448, 200, 1000], dtype=torch.int32)
    b = q_lens.numel()
    used = [-(-(int(lens[i]) + int(q_lens[i])) // bs) if q_lens[i] else 0 for i in range(b)]
    nb = sum(used) + 8
    perm = torch.randperm(nb, generator=torch.Generator().manual_seed(1)).tolist()
    tables = torch.full((b, mbs), 1 << 30, dtype=torch.int32)
    at = 0
    for i in range(b):
        tables[i, : used[i]] = torch.tensor(perm[at: at + used[i]], dtype=torch.int32)
        at += used[i]
    bf = torch.bfloat16
    q = torch.randn((b, c, hq, d), generator=gen, device=dev).to(bf)
    kc = torch.randn((nb, hkv, bs, d), generator=gen, device=dev).to(bf)
    vc = torch.randn((nb, hkv, bs, d), generator=gen, device=dev).to(bf)
    rope = LlamaRotaryEmbedding(d, 4096, 10000.0, dev)
    cos, sin = (t.reshape(b, c, d) for t in rope(c, lens.to(dev)))
    return dict(q=q, cos=cos, sin=sin, key_cache=kc, value_cache=vc, block_tables=tables.to(dev),
                seq_lens=lens.to(dev), q_lens=q_lens.to(dev)), used


def paged_cost(args: dict, used) -> tuple:
    """Bytes the attention must move (q, rope rows, the used K/V blocks,
    tables, lens, output) and the flops its valid rows need."""
    q, kc = args["q"], args["key_cache"]
    b, c, hq, d = q.shape
    _, hkv, bs, _ = kc.shape
    lens, q_lens = args["seq_lens"].tolist(), args["q_lens"].tolist()
    cos = args["cos"]
    nbytes = 2 * q.numel() * q.element_size() + 2 * cos.numel() * cos.element_size()  # q, out; cos, sin
    nbytes += sum(used) * 2 * hkv * bs * d * kc.element_size() + args["block_tables"].numel() * 4 + 2 * b * 4
    flops = sum(4 * d * hq * (lens[i] + j + 1) for i in range(b) for j in range(q_lens[i]))
    return nbytes, flops


def check_kernels(dev, card: dict) -> dict:
    """Phase 3: every kernel against its plain version at the 7B serving
    shapes, with its times; returns the per-kernel records."""
    import torch
    import torch.nn.functional as tF
    from paddle_tpu_torch.kernels.fused import (
        fused_embed_rms_norm, fused_embed_rms_norm_plain,
        fused_rms_norm_residual, fused_rms_norm_residual_plain,
    )
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_flash_chunk_fused, paged_flash_chunk_fused_plain, rope_rows,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    records = {}

    # A: rope-fused paged chunk attention, 7B MHA geometry and a GQA one
    for hq, hkv in ((32, 32), (32, 8)):
        args, used = paged_batch(dev, gen, hq, hkv)
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
        nbytes, flops = paged_cost(args, used)
        run, run_plain = (lambda: paged_flash_chunk_fused(**args)), (lambda: paged_flash_chunk_fused_plain(**args))
        # yardstick only (the port never calls it): SDPA over the dense
        # gathered K/V of the used blocks, q already roped
        b, c, _, d = args["q"].shape
        nb, _, bs, _ = args["key_cache"].shape
        n_blk = max(used)
        tab = args["block_tables"][:, :n_blk].long().clamp(0, nb - 1)
        kd = args["key_cache"][tab].permute(0, 2, 1, 3, 4).reshape(b, hkv, n_blk * bs, d)
        vd = args["value_cache"][tab].permute(0, 2, 1, 3, 4).reshape(b, hkv, n_blk * bs, d)
        qr = rope_rows(args["q"], args["cos"][:, :, None], args["sin"][:, :, None]).transpose(1, 2)
        pos = torch.arange(n_blk * bs, device=dev)
        mask = pos[None, None, :] < (args["seq_lens"][:, None] + torch.arange(c, device=dev)[None] + 1)[:, :, None]
        mask = mask[:, None]
        records["paged_chunk_fused"] = dict(
            source="paddle_tpu_torch/kernels/csrc/paged_chunk_fused.cu", max_abs_err=err,
            ms=device_ms(run), plain_ms=device_ms(run_plain, iters=5),
            library_ms=device_ms(lambda: tF.scaled_dot_product_attention(qr, kd, vd, attn_mask=mask)),
            call_ms=call_ms(run), plain_call_ms=call_ms(run_plain, iters=5), **bound(nbytes, flops),
        )
        emit({"phase": "kernel_check", "kernel": "paged_chunk_fused", "hq": hq, "hkv": hkv,
              "tolerance": "1e-4 + 2^-7*|x|", "bytes": nbytes, "flops": flops,
              **records["paged_chunk_fused"], "card": card})

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
        call_ms=call_ms(run), plain_call_ms=call_ms(run_plain), **bound(n * 4 + 3 * n * h * 2 + h * 2, 4 * n * h),
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
        call_ms=call_ms(run), plain_call_ms=call_ms(run_plain), **bound(4 * n * h * 2 + h * 2, 5 * n * h),
    )
    emit({"phase": "kernel_check", "kernel": "rms_residual", "tolerance": "1 bf16 ulp; r bitwise",
          **records["rms_residual"], "card": card})
    return records


# -- serving -------------------------------------------------------------------

def plain_logits(model, ids, caches, tables, lens, active, q_lens, dtype):
    """The same step as ``model(ids, pasts)``, written out with every
    kernel's plain version, computed in ``dtype`` (each weight cast as it is
    used): in bf16 it is the plain path the kernel path is held to, in fp32
    the reference both are measured against."""
    import torch
    from paddle_tpu_torch.incubate.nn.functional import _rope_apply_xla, block_cache_append_chunk
    from paddle_tpu_torch.kernels.fused import fused_embed_rms_norm_plain, fused_rms_norm_residual_plain
    from paddle_tpu_torch.kernels.paged_attention import paged_flash_chunk_fused_plain
    from paddle_tpu_torch.nn.functional import swiglu

    def w(mod):
        return mod.weight.to(dtype)

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
        kc, vc = caches[i]
        block_cache_append_chunk(kc, vc, k, v, tables, lens, q_lens, slot_mask=active)
        a = paged_flash_chunk_fused_plain(q, cos.reshape(b, c, hd), sin.reshape(b, c, hd), kc, vc, tables, lens, attend)
        post = layer.post_attention_layernorm
        h, residual = fused_rms_norm_residual_plain(a.reshape(b, c, nh * hd) @ w(att.o_proj), w(post), residual, post.epsilon)
        m = swiglu(h @ w(mlp.gate_proj), h @ w(mlp.up_proj)) @ w(mlp.down_proj)
        nxt = layers[i + 1].input_layernorm if i + 1 < len(layers) else llama.norm
        h, residual = fused_rms_norm_residual_plain(m, w(nxt), residual, nxt.epsilon)
    return h @ w(model.lm_head)


def check_logits(model, dev, card: dict) -> None:
    """Phase 5: prefill a small pool through the kernel path, then run one
    mixed step (decode row, continuing chunk, idle slot, full chunk) through
    the kernel path, through the plain versions in bf16, and through the
    plain versions in fp32 on copies of the pool. A bf16 path's rounding
    differences grow through 32 layers of random weights, so the kernel path
    is held to the plain bf16 path's own distance from the fp32 reference:
    its relative L2 error may exceed the plain path's by at most 25%, and its
    top-1 agreement may trail the plain path's by at most 0.05."""
    import torch

    cfg = model.config
    hd = cfg.hidden_size // cfg.num_attention_heads
    shape = (64, cfg.num_key_value_heads, 16, hd)
    caches = [(torch.zeros(shape, dtype=model.dtype, device=dev), torch.zeros(shape, dtype=model.dtype, device=dev))
              for _ in range(cfg.num_hidden_layers)]
    gen = torch.Generator(device=dev).manual_seed(3)
    tables = torch.arange(64, dtype=torch.int32, device=dev).reshape(4, 16)
    active = torch.tensor([True, True, False, True], device=dev)
    with torch.inference_mode():
        ids = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen, device=dev)
        q0 = torch.tensor([64, 40, 0, 64], dtype=torch.int32, device=dev)
        model(ids, [(kc, vc, tables, torch.zeros_like(q0), active, q0) for kc, vc in caches])
        plain_pools = [(kc.clone(), vc.clone()) for kc, vc in caches]
        f32_pools = [(kc.float(), vc.float()) for kc, vc in caches]
        q1 = torch.tensor([1, 24, 0, 64], dtype=torch.int32, device=dev)
        ids = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen, device=dev)
        got = model(ids, [(kc, vc, tables, q0, active, q1) for kc, vc in caches]).float()
        plain = plain_logits(model, ids, plain_pools, tables, q0, active, q1, torch.bfloat16).float()
        ref = plain_logits(model, ids, f32_pools, tables, q0, active, q1, torch.float32)
    rows = torch.arange(64, device=dev)[None, :] < (q1 * active)[:, None]
    got, plain, ref = got[rows], plain[rows], ref[rows]

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    def top1(a, b):
        return float((a.argmax(-1) == b.argmax(-1)).float().mean())

    out = {"kernel_vs_fp32_rel_l2": rel(got, ref), "plain_vs_fp32_rel_l2": rel(plain, ref),
           "kernel_vs_plain_rel_l2": rel(got, plain), "kernel_vs_fp32_top1": top1(got, ref),
           "plain_vs_fp32_top1": top1(plain, ref), "kernel_vs_plain_max_abs_err": float((got - plain).abs().max())}
    ok = (out["kernel_vs_fp32_rel_l2"] <= 1.25 * out["plain_vs_fp32_rel_l2"]
          and out["kernel_vs_fp32_top1"] >= out["plain_vs_fp32_top1"] - 0.05 and bool(torch.isfinite(got).all()))
    emit({"phase": "logits", "rows": int(rows.sum()), **out,
          "tolerance": "kernel_vs_fp32_rel_l2 <= 1.25 * plain_vs_fp32_rel_l2; top1 within 0.05 of plain's",
          "card": card})
    if not ok:
        fail(f"kernel-path logits are further from the fp32 reference than the plain path's: {out}")


KERNEL_CATEGORIES = (  # device kernel name substring -> category
    ("paged_chunk_fused", "attention (kernel A)"), ("embed_rms", "embed_rms (kernel B)"),
    ("rms_residual", "rms_residual (kernel C)"), ("gemm", "matmul"), ("cutlass", "matmul"),
    ("xmma", "matmul"), ("nvjet", "matmul"), ("Memcpy", "memcpy"), ("Memset", "memcpy"),
    ("index", "kv append / gathers"), ("nonzero", "kv append / gathers"), ("gather", "kv append / gathers"),
    ("scatter", "kv append / gathers"),
)


def profile_steps(eng, prompts, card: dict, warm: int = 3, steps: int = 3) -> None:
    """Where a serving step's time goes: ``torch.profiler`` over ``steps``
    engine steps (after ``warm`` unprofiled ones) on a fresh set of
    requests; device time by kernel category, and the device's idle share
    of the wall time. The engine is drained afterwards."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        eng.add_request(p, max_new_tokens=32)
    for _ in range(warm):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.run()
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
    emit({"phase": "profile", "steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
          "device_busy_ms_per_step": busy / steps / 1e3,
          "device_idle_share": (1 - busy / wall_us) if spans else None,
          "device_ms_per_step_by_category": {k: v / steps / 1e3 for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1])},
          "top_kernels_ms_per_step": {k: v / steps / 1e3 for k, v in top},
          "cuda_events": len(spans), "card": card})


def serve(dev, card: dict):
    """Phase 4: Llama-2-7B through the engine; returns the model and the
    launch counts of the timed run."""
    import numpy as np
    import torch
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.kernels.select import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg = LlamaConfig.llama2_7b()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    eng = ContinuousBatchingEngine(model, max_slots=8, block_size=16, prefill_chunk=64,
                                   max_model_len=2048, prompt_bucket=512)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in rng.integers(64, 513, 16)]

    reset_launch_counts()
    t_run = time.perf_counter()
    for p in prompts:
        eng.add_request(p, max_new_tokens=32)
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
    steps = eng.stats["steps"]

    gen_tokens = sum(len(r.generated) for r in done.values())
    ttft = sorted(r.admit_time - r.arrival_time for r in done.values())
    pool = eng.pool_stats()
    emit({
        "phase": "serve", "model": "llama2_7b (seeded random bf16 weights)", "requests": len(prompts),
        "finished": len(done), "prompt_tokens": int(sum(p.size for p in prompts)),
        "generated_tokens": gen_tokens, "steps": steps, "prefill_steps": len(prefill_ms),
        "decode_only_steps": len(decode_ms), "setup_s": setup_s, "run_s": run_s,
        "decode_tokens_per_s": gen_tokens / run_s,
        "step_ms_p50": float(np.median(prefill_ms + decode_ms)),
        "prefill_step_ms_p50": float(np.median(prefill_ms)) if prefill_ms else None,
        "decode_step_ms_p50": float(np.median(decode_ms)) if decode_ms else None,
        "ttft_ms_p50": float(np.median(ttft)) * 1e3, "ttft_ms_max": ttft[-1] * 1e3,
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "launches": counts, "pool": pool, "card": card,
    })
    if len(done) != len(prompts) or any(len(r.generated) != 32 for r in done.values()):
        fail("not every request finished with 32 tokens")
    layers = cfg.num_hidden_layers  # 32: A once per layer, C twice per layer, B once per step
    want = {"paged_chunk_fused": layers * steps, "embed_rms": steps, "rms_residual": 2 * layers * steps}
    if counts != want:
        fail(f"launch counts {counts} != {want} for {steps} steps")
    if pool["free"] != pool["total"]:
        fail(f"the pool did not drain: {pool}")
    profile_steps(eng, prompts[:8], card)
    if eng.pool_stats()["free"] != pool["total"]:
        fail("the pool did not drain after the profiled steps")
    return model, counts


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
    from paddle_tpu_torch.kernels.select import KERNELS

    dev = torch.device("cuda", 0)
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    card = {"name": name, "nvidia_smi": smi}
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda, "kind": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi})

    info = build.build_info()
    ptxas = [ln.strip() for ln in info["log"].splitlines() if "ptxas info" in ln and ("Used" in ln or "Compiling" in ln)]
    emit({"phase": "build", "seconds": info["seconds"], "cached": info["cached"], "ptxas": ptxas})

    records = check_kernels(dev, card)
    model, counts = serve(dev, card)  # the engine and its pool are released here
    check_logits(model, dev, card)
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": records[k]["source"], "replaces": KERNELS[k],
         "launches": counts[k], "max_abs_err": records[k]["max_abs_err"], "ms": records[k]["ms"],
         "plain_ms": records[k]["plain_ms"], "bound_ms": records[k]["bound_ms"],
         "bound_by": records[k]["bound_by"], "library_ms": records[k]["library_ms"]}
        for k in KERNELS
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
