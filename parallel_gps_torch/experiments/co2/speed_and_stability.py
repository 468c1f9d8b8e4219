"""CO2 speed & stability sweep (counterpart:
parallel_gps_tpu/experiments/co2/speed_and_stability.py): the reference's
file is a copy of the toy-model sweep, so, as the JAX package does, this
re-exports it."""
from parallel_gps_torch.experiments.toy_models.speed_and_stability import main

if __name__ == "__main__":
    main()
