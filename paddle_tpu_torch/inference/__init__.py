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

__all__ = [
    "AdmissionPolicy",
    "ContinuousBatchingEngine",
    "EmptyPromptError",
    "FIFOAdmission",
    "InferenceRequest",
    "IntakeError",
    "InvalidTokenBudgetError",
    "PromptTooLongError",
    "RequestTooLongError",
    "RequestUnservableError",
]
