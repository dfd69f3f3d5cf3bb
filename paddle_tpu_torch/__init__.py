"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The port runs on an NVIDIA Hopper card: plain PyTorch around kernels
written by hand in CUDA C++ (``kernels/csrc``), built with ``nvcc`` for
``sm_90a`` at first use. It imports neither JAX nor ``paddle_tpu``; the JAX
package stays beside it as the reference it is tested against. It serves
Llama through the continuous-batching engine::

    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.inference import ContinuousBatchingEngine

    model = LlamaForCausalLM(LlamaConfig.llama2_7b(), seed=0)  # on cuda
    eng = ContinuousBatchingEngine(model, max_slots=8, prefill_chunk=64)
    eng.add_request(prompt_ids, max_new_tokens=32)
    results = eng.run()

decodes a static batch greedily over the paged cache::

    out = model.generate_paged(ids, max_new_tokens=32, block_size=16)  # [B, S + 32] int32

and trains it at every JAX default — FlashMask document masks, recompute,
AdamW with fp32 master weights, and the fused loss head (the logits are
never materialised, so the second return is None)::

    from paddle_tpu_torch.optimizer import AdamW

    model = LlamaForCausalLM(LlamaConfig(recompute=True), seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(), multi_precision=True)
    loss, _ = model(ids, labels=labels, startend_row_indices=bounds)
    loss.backward()
    opt.step()
    opt.clear_grad()

Entry points run on ``cuda`` and raise without it, unless the caller passes
``device="cpu"``, where every kernel's plain PyTorch version runs instead.
"""

from paddle_tpu_torch.flags import get_flags, set_flags

__all__ = ["get_flags", "set_flags"]
