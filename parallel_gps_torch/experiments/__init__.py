"""Experiment entry points (counterpart: parallel_gps_tpu/experiments).

Run as modules, on the card by default, e.g.::

    python -m parallel_gps_torch.experiments.toy_models.speed_and_stability \
        --model pssgp --cov Matern32 --n-seeds 3
    python -m parallel_gps_torch.experiments.sunspot.map --data-dir data/
    python -m parallel_gps_torch.experiments.sunspot.mcmc --platform cpu
    python -m parallel_gps_torch.experiments.co2.mcmc --n-samples 50

The figures (``plots.py``) are not ported yet (ROADMAP A12b).
"""
