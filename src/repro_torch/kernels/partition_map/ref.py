"""Plain PyTorch version of the partition benchmark map (paper Fig. 4/6):
k(x) = sqrt(sin^2 x + cos^2 x), = 1 up to rounding."""
import torch


def partition_map_ref(x: "torch.Tensor") -> "torch.Tensor":
    s, c = torch.sin(x), torch.cos(x)
    return torch.sqrt(s * s + c * c)
