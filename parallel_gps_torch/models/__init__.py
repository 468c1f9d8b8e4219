from parallel_gps_torch.models import params
from parallel_gps_torch.models.gpr import GPR, DenseGP
from parallel_gps_torch.models.ssgp import StateSpaceGP, merge_sorted

__all__ = ["DenseGP", "GPR", "StateSpaceGP", "merge_sorted", "params"]
