from parallel_gps_torch.kernels.base import Product, SDEKernel, Sum
from parallel_gps_torch.kernels.matern import Matern12, Matern32, Matern52
from parallel_gps_torch.kernels.periodic import Periodic
from parallel_gps_torch.kernels.rbf import RBF

__all__ = ["SDEKernel", "Sum", "Product", "Matern12", "Matern32", "Matern52", "Periodic", "RBF"]
