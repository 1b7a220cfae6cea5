"""Model zoo on PyTorch: the dense decoder family so far."""
from repro_torch.models.model import get_model

__all__ = ["get_model"]
