from parallel_gps_torch.models import params
from parallel_gps_torch.models.gpr import GPR
from parallel_gps_torch.models.ssgp import StateSpaceGP, merge_sorted

__all__ = ["GPR", "StateSpaceGP", "merge_sorted", "params"]
