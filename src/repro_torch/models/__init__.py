"""Model zoo on PyTorch: the dense decoder and ssm (Mamba-2) families so far."""
from repro_torch.models.model import get_model

__all__ = ["get_model"]
