from deepvcp.loss.registration import (
    RegistrationResult,
    deepvcp_loss,
    svd_refine,
)

__all__ = ["RegistrationResult", "deepvcp_loss", "svd_refine"]
