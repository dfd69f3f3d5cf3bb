from paddle_tpu_torch.core.device import default_device, resolve_device

__all__ = ["default_device", "resolve_device"]
