"""Model zoo on PyTorch: the dense, moe, vlm, ssm (Mamba-2), encdec and
hybrid families."""
from repro_torch.models.model import batch_logical_specs, get_model, input_specs, make_batch

__all__ = ["batch_logical_specs", "get_model", "input_specs", "make_batch"]
