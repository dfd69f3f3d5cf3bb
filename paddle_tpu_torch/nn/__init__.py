from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_"]
