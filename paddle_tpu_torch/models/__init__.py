from paddle_tpu_torch.models.convert import from_paddle_tpu_state
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTModel
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["GPTConfig", "GPTForPretraining", "GPTModel", "LlamaConfig", "LlamaForCausalLM",
           "from_paddle_tpu_state"]
