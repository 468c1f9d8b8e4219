from parallel_gps_torch.ops import balance, disc, linalg, lyapunov, scan

__all__ = ["balance", "disc", "linalg", "lyapunov", "scan"]
