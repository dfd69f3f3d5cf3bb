"""Layers of the port (counterpart of ``paddle_tpu/nn/layer``): the ones the
GPT path uses, as ``nn.Module``s with an explicit device and dtype."""

from paddle_tpu_torch.nn.layer.common import Dropout, Embedding, Linear
from paddle_tpu_torch.nn.layer.norm import LayerNorm

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear"]
