from paddle_tpu_torch.models.convert import from_paddle_tpu_state
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["LlamaConfig", "LlamaForCausalLM", "from_paddle_tpu_state"]
