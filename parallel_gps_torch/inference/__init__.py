from parallel_gps_torch.inference.optim import fit_adam, fit_lbfgs, make_log_posterior, make_loss

__all__ = ["fit_adam", "fit_lbfgs", "make_loss", "make_log_posterior"]
