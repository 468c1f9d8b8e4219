from parallel_gps_torch.kernels.base import SDEKernel
from parallel_gps_torch.kernels.matern import Matern12, Matern32, Matern52
from parallel_gps_torch.kernels.rbf import RBF

__all__ = ["SDEKernel", "Matern12", "Matern32", "Matern52", "RBF"]
