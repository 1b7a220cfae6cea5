"""Plain PyTorch version of the PRK 3-point stencil (paper Fig. 3):
s(x_i) = 0.5*x_{i-1} + x_i + 0.5*x_{i+1}, zero boundary."""
import torch


def stencil_ref(x: "torch.Tensor") -> "torch.Tensor":
    zero = x.new_zeros(1)
    left = torch.cat([zero, x[:-1]])
    right = torch.cat([x[1:], zero])
    return 0.5 * left + x + 0.5 * right
