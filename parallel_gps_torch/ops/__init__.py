from parallel_gps_torch.ops import balance, disc, linalg, lyapunov

__all__ = ["balance", "disc", "linalg", "lyapunov"]
