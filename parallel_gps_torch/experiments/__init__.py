"""Experiment entry points (counterpart: parallel_gps_tpu/experiments; so far the
MCMC runner of ``common.py`` only)."""
