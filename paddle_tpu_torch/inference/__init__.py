from paddle_tpu_torch.inference.engine import (
    AdmissionPolicy,
    ContinuousBatchingEngine,
    EmptyPromptError,
    FIFOAdmission,
    InferenceRequest,
    IntakeError,
    InvalidTokenBudgetError,
    PromptTooLongError,
    RequestTooLongError,
    RequestUnservableError,
)
from paddle_tpu_torch.inference.prefix_cache import PrefixCache

__all__ = [
    "AdmissionPolicy",
    "ContinuousBatchingEngine",
    "EmptyPromptError",
    "FIFOAdmission",
    "InferenceRequest",
    "IntakeError",
    "InvalidTokenBudgetError",
    "PrefixCache",
    "PromptTooLongError",
    "RequestTooLongError",
    "RequestUnservableError",
]
