from parallel_gps_torch.ops import balance, disc, expm, linalg, lyapunov, native, scan

__all__ = ["balance", "disc", "expm", "linalg", "lyapunov", "native", "scan"]
